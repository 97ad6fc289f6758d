"""PyTorch port vs the JAX package: model forward on the same weights.

The JAX weights (``transformer.init_params``) cross over as numpy through
``repro_torch.weights``; both packages run float32 on the CPU.

Tolerances: rtol/atol 1e-5 on hidden states, logits and prefill caches.
The two frameworks sum the same f32 products in different orders (XLA's
CPU dot vs PyTorch's GEMM), which leaves ~1e-6 relative noise after two
layers of O(1) activations; 1e-5 keeps a margin without hiding a real
difference (a wrong norm, rope or mask is >= 1e-2).  bf16 primitives are
held to one bf16 ulp (2^-7 relative) for the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core import budget as jbudget
from repro.core import spa_layer as jspa_layer
from repro.core.strategy import SPACache as JSPACache
from repro.dlm import decoding as jdecoding
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg, port_params, port_proxies
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core import spa_layer as tspa_layer
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.dlm import decoding as tdecoding
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _llada_reduced():
    return reduced(get_arch("llada-8b"))


@pytest.fixture(scope="module", params=["tiny", "llada_reduced"])
def model(request, tiny_cfg):
    cfg = tiny_cfg if request.param == "tiny" else _llada_reduced()
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = port_cfg(cfg)
    return cfg, params, tcfg, port_params(params, tcfg)


def _tokens(cfg, b=2, n=24, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 1, (b, n)).astype(np.int32)


def test_forward_hidden_and_logits_match_jax(model):
    cfg, params, tcfg, tparams = model
    toks = _tokens(cfg)
    h0 = jt.embed_inputs(params, cfg, {"tokens": jnp.asarray(toks)})
    h, _, _ = jt.forward_hidden(params, cfg, h0)
    logits = jt.logits_from_hidden(params, cfg, h)

    th0 = tt.embed_inputs(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    th, _ = tt.forward_hidden(tparams, tcfg, th0)
    tlogits = tt.logits_from_hidden(tparams, tcfg, th)
    np.testing.assert_array_equal(np32(th0), np32(h0))
    np.testing.assert_allclose(np32(th), np32(h), **TOL)
    np.testing.assert_allclose(np32(tlogits), np32(logits), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_cache_matches_jax(model, cache_dtype):
    """Prefill K/V/H^c and the singular-proxy identifiers (float caches
    within 1e-5; int8 codes within one quantization step)."""
    import dataclasses
    cfg, params, tcfg, tparams = model
    cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    strat = JSPACache(rank=cfg.spa.rank)
    proxies = strat.build_proxies(params, cfg)
    toks = _tokens(cfg)
    _, cache = jdecoding.prefill(params, cfg, {"tokens": jnp.asarray(toks)},
                                 proxies, strat)
    _, tcache = tdecoding.prefill(tparams, tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  port_proxies(proxies, tcfg),
                                  TSPACache(rank=cfg.spa.rank))
    for kind, bufs in cache.items():
        assert sorted(bufs) == sorted(tcache[kind])
        for name, a in bufs.items():
            t = tcache[kind][name]
            assert str(t.dtype).split(".")[-1] == np.asarray(a).dtype.name
            if np.asarray(a).dtype == np.int8:
                assert np.abs(np.asarray(a, np.int32)
                              - t.numpy().astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(np32(t), np32(a), rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_primitives_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, 4, 32)), dtype)
    w = jnp.asarray(rng.standard_normal((32,)) * 0.1, dtype)
    pos = jnp.asarray(rng.integers(0, 500, (2, 7)), jnp.int32)
    tx, tw = (torch.from_numpy(np32(a)).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        for a in (x, w))
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == jnp.float32
           else dict(rtol=2 ** -7, atol=2 ** -7))
    np.testing.assert_allclose(
        np32(tcommon.rms_norm(tx, tw, 1e-6)),
        np32(jcommon.rms_norm(x, w, 1e-6)), **tol)
    np.testing.assert_allclose(
        np32(tcommon.apply_rope(tx, torch.from_numpy(np.array(pos)),
                                10_000.0)),
        np32(jcommon.apply_rope(x, pos, 10_000.0)), **tol)


def test_gated_ffn_matches_jax():
    rng = np.random.default_rng(1)
    p = {k: jnp.asarray(rng.standard_normal(s) * 0.1, jnp.float32)
         for k, s in (("w_gate", (32, 64)), ("w_up", (32, 64)),
                      ("w_down", (64, 32)))}
    x = jnp.asarray(rng.standard_normal((3, 5, 32)), jnp.float32)
    want = jffn.apply_ffn(p, x, "silu")
    got = tffn.apply_ffn({k: torch.from_numpy(np.array(v))
                          for k, v in p.items()},
                         torch.from_numpy(np.array(x)), "silu")
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_init_params_layout_matches_jax(tiny_cfg):
    """The port's own init draws other numbers but the same tree, shapes
    and dtypes, on the device it is given."""
    want = jax.tree.map(lambda a: (a.shape, np.asarray(a).dtype.name),
                        jt.init_params(tiny_cfg, jax.random.PRNGKey(0)))
    got = tt.init_params(port_cfg(tiny_cfg), seed=0, device="cpu")

    def walk(w, g, path=""):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], f"{path}/{k}")
            else:
                assert g[k].device.type == "cpu"
                assert (tuple(g[k].shape),
                        str(g[k].dtype).split(".")[-1]) == w[k], \
                    f"{path}/{k}"
    walk(want, got)
    again = tt.init_params(port_cfg(tiny_cfg), seed=0, device="cpu")
    assert torch.equal(got["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"]), "seeded init repeats"


@pytest.mark.parametrize("n_layers,n,n_buckets", [
    (2, 96, 6), (8, 160, 3), (8, 256, 6), (32, 512, 6)])
def test_layer_ks_match_jax_regimes(n_layers, n, n_buckets):
    """The k each layer runs: exact below 8 layers, bucketed at 8 and up
    (LLaDA's 32 layers at N=512: segments (0,1,16) (1,5,32) (5,8,48)
    (8,10,64) (10,30,128) (30,32,80))."""
    cfg = get_arch("llada-8b")
    jcfg = reduced(cfg, n_layers=n_layers) if n_layers < 32 else cfg
    jstrat = JSPACache.from_spec(jcfg.spa)
    import dataclasses
    jstrat = dataclasses.replace(jstrat, n_buckets=n_buckets)
    ks = jstrat.k_schedule(jcfg, n)
    if n_layers >= 8 and jspa_layer._homogeneous_attention(jcfg):
        want = [k for a, b, k in jbudget.bucketize(ks, n_buckets)
                for _ in range(a, b)]
    else:
        want = ks
    tcfg = port_cfg(jcfg)
    tstrat = dataclasses.replace(TSPACache.from_spec(tcfg.spa),
                                 n_buckets=n_buckets)
    assert tspa_layer.layer_ks(tcfg, tstrat, n) == want
    if n_layers == 32:
        assert jbudget.bucketize(ks, 6) == [
            (0, 1, 16), (1, 5, 32), (5, 8, 48), (8, 10, 64), (10, 30, 128),
            (30, 32, 80)]


def test_port_configs_match_jax():
    import dataclasses
    for name in ("llada-8b", "internlm2-1.8b"):
        assert dataclasses.asdict(tget_arch(name)) == dataclasses.asdict(
            get_arch(name))


def test_cache_layout_and_h_commit_match_jax(tiny_cfg):
    """Zeroed cache layout (float and int8) and an H^c commit with a
    sentinel index, against the JAX package's dense cache helpers."""
    import dataclasses
    from repro.core import cache as jcache
    from repro_torch.core import cache as tcache
    rng = np.random.default_rng(5)
    for cache_dtype in ("float32", "int8"):
        cfg = dataclasses.replace(tiny_cfg, cache_dtype=cache_dtype)
        tcfg = port_cfg(cfg)
        want = jcache.init_model_cache(cfg, 2, 20, JSPACache(rank=8))
        got = tcache.init_model_cache(tcfg, 2, 20, TSPACache(rank=8),
                                      device="cpu")
        assert sorted(got) == sorted(want)
        for kind, bufs in want.items():
            assert sorted(got[kind]) == sorted(bufs)
            for name, a in bufs.items():
                t = got[kind][name]
                assert tuple(t.shape) == a.shape and not t.any()
                assert str(t.dtype).split(".")[-1] == np.asarray(a).dtype.name
        idx = np.array([[3, 19, 20], [0, 7, 11]], np.int32)   # 20 drops
        rows = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
        j_sl = jax.tree.map(lambda a: a[0], want["attn"])
        j_out = jcache.write_h(j_sl, jnp.asarray(idx), jnp.asarray(rows),
                               jcache.CachePolicy.from_config(cfg))
        t_sl = {n: a[0] for n, a in got["attn"].items()}
        tcache.write_h(t_sl, torch.from_numpy(idx), torch.from_numpy(rows),
                       tcache.CachePolicy.from_config(tcfg))
        for name in ("h", "h_scale") if cache_dtype == "int8" else ("h",):
            np.testing.assert_allclose(np32(t_sl[name]), np32(j_out[name]),
                                       rtol=1e-6, atol=1e-6)


def test_mask_tail_scores_matches_jax():
    scores = np.random.default_rng(6).random((3, 12)).astype(np.float32)
    kv_len = np.array([12, 5, 0], np.int32)
    want = jspa_layer._mask_tail_scores(jnp.asarray(scores), 12,
                                        jnp.asarray(kv_len))
    got = tspa_layer._mask_tail_scores(torch.from_numpy(scores), 12,
                                       torch.from_numpy(kv_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t_scores = torch.from_numpy(scores)
    assert tspa_layer._mask_tail_scores(t_scores, 12, None) is t_scores
