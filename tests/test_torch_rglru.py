"""PyTorch port vs the JAX package: the RG-LRU recurrence and block.

- ``rglru_scan`` (plain, what the port runs on the CPU and the oracle its
  CUDA kernel is held to on the card) against the JAX Pallas kernel in
  interpret mode and ``ref.rglru_scan_ref`` (both sequential with an f32
  carry: 1e-6), and against ``models.rglru.linear_recurrence`` (an
  associative scan inside chunks, which sums in another order: 1e-5);
- ``_temporal_conv``, ``rglru_core`` (forward and reversed) and
  ``apply_rglru`` (bidirectional and one-way) on carried weights, and a
  whole RG-LRU transformer block: 1e-5 (the recurrence's order, then f32
  matmuls in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro.models import rglru as jrglru
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg, port_params
from repro_torch.kernels import _lib
from repro_torch.kernels import rglru_scan as trs
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as tt
from repro_torch.weights import to_tensor

torch.set_num_threads(1)
SCAN = dict(rtol=1e-6, atol=1e-6)
F32 = dict(rtol=1e-5, atol=1e-5)


def _ab(b, n, d, seed=4):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, n, d))))
         ).astype(np.float32)
    x = (rng.standard_normal((b, n, d)) * 0.1).astype(np.float32)
    return a, x


@pytest.mark.parametrize("n,d", [(64, 32), (300, 64), (128, 8)])
def test_rglru_scan_matches_pallas_and_ref(n, d):
    a, b = _ab(2, n, d)
    got = trs.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2, n, d)
    for row in range(2):
        want_k = jrglru_scan(jnp.asarray(a[row]), jnp.asarray(b[row]),
                             interpret=True, chunk=32, block_d=32)
        want_r = jref.rglru_scan_ref(jnp.asarray(a[row]),
                                     jnp.asarray(b[row]))
        np.testing.assert_allclose(np32(got[row]), np32(want_k), **SCAN)
        np.testing.assert_allclose(np32(got[row]), np32(want_r), **SCAN)


def test_rglru_scan_bf16_matches_ref():
    """bf16 a and b, f32 carry, bf16 out: one bf16 ulp (2^-8 relative)."""
    a, b = _ab(1, 200, 48, seed=5)
    aj = jnp.asarray(a[0]).astype(jnp.bfloat16)
    bj = jnp.asarray(b[0]).astype(jnp.bfloat16)
    want = jref.rglru_scan_ref(aj, bj)
    got = trs.rglru_scan(to_tensor(np.asarray(aj), "cpu")[None],
                         to_tensor(np.asarray(bj), "cpu")[None])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got[0]), np32(want), rtol=2 ** -8,
                               atol=1e-6)


def test_rglru_scan_matches_linear_recurrence():
    a, b = _ab(2, 600, 16, seed=6)
    want = jrglru.linear_recurrence(jnp.asarray(a), jnp.asarray(b))
    got = trs.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(np32(got), np32(want), **F32)


def test_rglru_scan_cpu_takes_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build the kernels")

    monkeypatch.setattr(_lib, "load", no_build)
    before = _lib.launch_counts()
    a, b = _ab(1, 40, 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(trs.rglru_scan(ta, tb), trs.rglru_scan_plain(ta, tb))
    assert _lib.launch_counts() == before
    with pytest.raises(ValueError):
        trs.rglru_scan(ta, tb[:, :20])


def _mixer(cfg, seed=0):
    p = jrglru.init_rglru_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    # non-trivial biases and decays (the init's are constants)
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_x", "log_lambda"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape)
                              .astype(np.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _cfg():
    return reduced(get_arch("recurrentgemma-9b"), n_layers=3)


def test_temporal_conv_and_core_match_jax():
    cfg = _cfg()
    jp, tp = _mixer(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 90, cfg.d_model)).astype(np.float32)
    conv_j = jrglru._temporal_conv(jnp.asarray(x), jp["conv_kernel"])
    conv_t = trglru._temporal_conv(torch.from_numpy(x), tp["conv_kernel"])
    np.testing.assert_allclose(np32(conv_t), np32(conv_j), **SCAN)
    for reverse in (False, True):
        want = jrglru.rglru_core(jp, jnp.asarray(x), reverse=reverse)
        got = trglru.rglru_core(tp, torch.from_numpy(x), reverse=reverse)
        np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_apply_rglru_matches_jax(bidirectional):
    cfg = _cfg()
    jp, tp = _mixer(cfg, seed=1)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    want = jrglru.apply_rglru(jp, jnp.asarray(x), cfg, bidirectional)
    got = trglru.apply_rglru(tp, torch.from_numpy(x), port_cfg(cfg),
                             bidirectional)
    np.testing.assert_allclose(np32(got), np32(want), **F32)


def test_rglru_block_matches_jax():
    """One RG-LRU transformer block (post norms, gated GELU FFN) on the
    JAX init's weights; an RG-LRU block keeps no cache entries."""
    cfg = dataclasses.replace(_cfg(), post_norms=True)
    params = jt.init_params(cfg, jax.random.PRNGKey(2))
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    bp = jax.tree.map(lambda t: t[0], params["blocks"]["rglru"])
    want, _, entries = jt.apply_block_dense(cfg, "rglru", bp, jnp.asarray(h),
                                            collect_cache=True)
    assert entries is None
    got, t_entries = tt.apply_block_dense(tcfg, "rglru",
                                          tt.layer_params(tparams, tcfg, 0),
                                          torch.from_numpy(h),
                                          collect_cache=True)
    assert t_entries is None
    np.testing.assert_allclose(np32(got), np32(want), **F32)
