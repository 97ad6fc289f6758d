"""PyTorch port vs the JAX package: the four hot-path kernels.

Each kernel's plain PyTorch version (what the port runs on the CPU, and
the oracle its CUDA kernel is held to on the card) is compared with the
JAX package on the same numpy inputs:

  proxy_score          vs the XLA path ``strategy.project`` +
                       ``strategy.score`` (the path XlaBackend runs);
  gather_norm          vs the Pallas kernel in interpret mode;
  sparse_attention     vs ``flash_attention`` and the Pallas kernel in
                       interpret mode (GQA, window, soft_cap, kv_len, int8);
  scatter_update_multi vs the Pallas kernel in interpret mode.

Tolerances: f32 results agree to 1e-5 (the frameworks sum in different
orders, ~1e-7 relative); bf16 results to one bf16 ulp (2^-7 relative),
since a different f32 sum can round to the neighbouring bf16 value; row
copies (gather, scatter) must be bit-identical.  The CUDA kernels are
held to these plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache
from repro.kernels.proxy_score import gather_norm as jgather_norm
from repro.kernels.scatter_update import (scatter_update_multi as
                                          jscatter_multi)
from repro.kernels.sparse_attention import sparse_attention as jsparse
from repro.models.attention import flash_attention as jflash

from _torch_parity import np32
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import scatter_update as tsc
from repro_torch.kernels import sparse_attention as tsa
from repro_torch.models.attention import flash_attention as tflash

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """numpy float array -> (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np32(j)).to(_TORCH[jnp.dtype(dtype).name])


@pytest.mark.parametrize("b,n,d,r", [(2, 40, 64, 16), (1, 33, 128, 32),
                                     (3, 17, 96, 8)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_proxy_score_matches_xla_path(b, n, d, r, dtype):
    rng = np.random.default_rng(0)
    x, tx = _pair(rng.standard_normal((b, n, d)), dtype)
    w, tw = _pair(rng.standard_normal((d, r)) * 0.2, dtype)
    pc, tpc = _pair(rng.standard_normal((b, n, r)), dtype)
    strat = JSPACache(rank=r)
    p_now = strat.project(x, {}, w)
    scores = strat.score(p_now, pc)
    t_scores, t_p = tps.proxy_score_plain(tx, tw, tpc)
    assert t_p.dtype == tx.dtype and t_scores.dtype == torch.float32
    tol = F32 if dtype == jnp.float32 else BF16
    np.testing.assert_allclose(np32(t_p), np32(p_now), **tol)
    np.testing.assert_allclose(np32(t_scores), np32(scores),
                               rtol=1e-5, atol=1e-5 if dtype == jnp.float32
                               else 1e-2)
    # unchanged rows tie at exactly cosine 1 in both packages
    same, _ = tps.proxy_score_plain(tx, tw, t_p)
    assert float((same - 1).abs().max()) < 1e-6
    # the CPU wrapper is the plain version
    w_scores, w_p = tps.proxy_score(tx, tw, tpc)
    assert torch.equal(w_scores, t_scores) and torch.equal(w_p, t_p)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_norm_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    h, th = _pair(rng.standard_normal((2, 50, 96)), dtype)
    w, tw = _pair(rng.standard_normal((96,)) * 0.1, dtype)
    idx = np.array([[3, 49, -2, 0, 17, 60, 5], [44, 1, 100, -7, 9, 9, 2]],
                   np.int32)                      # clamps both ways
    rows, normed = jgather_norm(h, jnp.asarray(idx), w, 1e-6,
                                interpret=True, block_g=4)
    t_rows, t_normed = tps.gather_norm_plain(th, torch.from_numpy(idx), tw,
                                             1e-6)
    np.testing.assert_array_equal(np32(t_rows), np32(rows))
    np.testing.assert_allclose(np32(t_normed), np32(normed),
                               **(F32 if dtype == jnp.float32 else BF16))
    w_rows, w_normed = tps.gather_norm(th, torch.from_numpy(idx), tw, 1e-6)
    assert torch.equal(w_rows, t_rows) and torch.equal(w_normed, t_normed)


ATTN_CASES = {
    "mha": dict(b=2, kq=12, n=64, h=4, kvh=4, hd=16),
    "gqa_ragged_window_softcap": dict(b=2, kq=20, n=150, h=4, kvh=2, hd=32,
                                      window=24, soft_cap=30.0),
    "mqa_kv_len": dict(b=3, kq=9, n=96, h=4, kvh=1, hd=16,
                       kv_len=[96, 40, 0]),
    "int8_scales_gqa": dict(b=2, kq=16, n=80, h=4, kvh=2, hd=16, quant=True,
                            window=10),
    # head_dims the CUDA body pads with zero columns (h2o-danube3's 120,
    # hubert-xlarge's 80)
    "hd120_gqa8on2_window": dict(b=2, kq=10, n=70, h=8, kvh=2, hd=120,
                                 window=20),
    "hd80_mha": dict(b=2, kq=9, n=48, h=3, kvh=3, hd=80),
}


def _attn_inputs(case, seed=2):
    rng = np.random.default_rng(seed)
    c = {**dict(window=0, soft_cap=0.0, kv_len=None, quant=False), **case}
    q = rng.standard_normal((c["b"], c["kq"], c["h"], c["hd"])
                            ).astype(np.float32)
    qpos = rng.integers(0, c["n"], (c["b"], c["kq"])).astype(np.int32)
    shape = (c["b"], c["n"], c["kvh"], c["hd"])
    if c["quant"]:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.02).astype(np.float16)
        vs = (rng.random(shape[:3]) * 0.02).astype(np.float16)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    kv_len = (None if c["kv_len"] is None
              else np.asarray(c["kv_len"], np.int32))
    return c, q, qpos, k, v, ks, vs, kv_len


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_sparse_attention_matches_jax(name):
    c, q, qpos, k, v, ks, vs, kv_len = _attn_inputs(ATTN_CASES[name])
    kw = dict(window=c["window"], soft_cap=c["soft_cap"])
    want_flash = jflash(_j(q), _j(k), _j(v), k_scale=_j(ks), v_scale=_j(vs),
                        q_positions=_j(qpos), kv_len=_j(kv_len),
                        block_q=8, block_k=32, **kw)
    want_pallas = jsparse(_j(q), _j(k), _j(v), _j(qpos), k_scale=_j(ks),
                          v_scale=_j(vs), kv_len=_j(kv_len), block_q=8,
                          block_k=32, interpret=True, **kw)
    got = tsa.sparse_attention_plain(_t(q), _t(k), _t(v), _t(qpos),
                                     k_scale=_t(ks), v_scale=_t(vs),
                                     kv_len=_t(kv_len), block_k=32, **kw)
    np.testing.assert_allclose(np32(got), np32(want_flash), **F32)
    np.testing.assert_allclose(np32(got), np32(want_pallas), **F32)
    # one kv block (the port's default at these sizes) is the same math
    one = tsa.sparse_attention_plain(_t(q), _t(k), _t(v), _t(qpos),
                                     k_scale=_t(ks), v_scale=_t(vs),
                                     kv_len=_t(kv_len), **kw)
    np.testing.assert_allclose(np32(one), np32(want_flash), **F32)
    if kv_len is not None:       # fully released rows output exact zeros
        dead = kv_len == 0
        assert not np.any(np32(got)[dead])
    wrapped = tsa.sparse_attention(_t(q), _t(k), _t(v), _t(qpos),
                                   k_scale=_t(ks), v_scale=_t(vs),
                                   kv_len=_t(kv_len), **kw)
    assert torch.equal(wrapped, one)


def test_prefill_attention_matches_flash():
    """Contiguous positions (prefill) through the port's one attention."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    want = jflash(_j(q), _j(k), _j(v), soft_cap=20.0)
    got = tflash(_t(q), _t(k), _t(v), soft_cap=20.0)
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    via_backend = tbackend.TORCH_BACKEND.attention(_t(q), _t(k), _t(v),
                                                   soft_cap=20.0)
    assert torch.equal(via_backend, got)


def test_banded_grid_raises_instead_of_dense():
    """Where the JAX kernel takes its banded grid, the port takes it too,
    never the dense grid in its place: with a band narrower than the
    queries' spread (q_span 600 declared, positions 0 and 2000 in one q
    block) the keys past the band drop (the rows at 2000 see none and
    output 0), so the result differs from the dense grid's, and both
    backends give the plain banded version's numbers."""
    assert tsa.banded_engages(9000, 64, True, 600)
    assert not tsa.banded_engages(9000, 64, False, 600)
    assert not tsa.banded_engages(600, 64, True, 600)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 1, 8), generator=g)
    kv = torch.randn((1, 9000, 1, 8), generator=g)
    pos = torch.tensor([[0, 10, 2000, 2010]], dtype=torch.int32)
    dense = tsa.sparse_attention_plain(q, kv, kv, pos, window=64)
    band = tsa.band_for(pos, 9000, 64, 600)
    assert band[1] == 3 and band[0].tolist() == [0]   # keys [0, 1536)
    want = tsa.sparse_attention_plain(q, kv, kv, pos, window=64, band=band)
    assert torch.equal(want[:, :2], dense[:, :2])
    assert float((want[:, 2:] - dense[:, 2:]).abs().max()) > 1e-3
    for backend in (tbackend.TORCH_BACKEND, tbackend.CUDA_BACKEND):
        got = backend.attention(q, kv, kv, q_positions=pos, window=64,
                                banded=True, q_span=600)
        assert torch.equal(got, want)


def test_scatter_update_multi_matches_pallas():
    rng = np.random.default_rng(4)
    b, n, k = 2, 40, 12
    caches = [rng.standard_normal((b, n, 2, 8)).astype(np.float32),
              rng.integers(-127, 128, (b, n, 2, 8)).astype(np.int8),
              (rng.random((b, n, 2)) * 0.1).astype(np.float16),
              rng.standard_normal((b, n, 5)).astype(np.float32)]
    rows = [rng.standard_normal((b, k, 2, 8)).astype(np.float32),
            rng.integers(-127, 128, (b, k, 2, 8)).astype(np.int8),
            (rng.random((b, k, 2)) * 0.1).astype(np.float16),
            rng.standard_normal((b, k, 5)).astype(np.float32)]
    # unsorted, with out-of-range entries (-1, n, n + 7) that must drop
    idx = np.array([[7, 3, 39, -1, 20, 21, 22, 23, 24, 25, 26, n],
                    [0, n + 7, 5, 11, 2, 30, 31, 32, 33, 34, 35, 36]],
                   np.int32)
    want = jscatter_multi([jnp.asarray(c) for c in caches], jnp.asarray(idx),
                          [jnp.asarray(r) for r in rows], interpret=True,
                          block_k=4)
    got = [torch.from_numpy(c.copy()) for c in caches]
    out = tsc.scatter_update_multi_plain(got, torch.from_numpy(idx),
                                         [torch.from_numpy(r) for r in rows])
    assert all(o is g for o, g in zip(out, got)), "writes are in place"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    again = [torch.from_numpy(c.copy()) for c in caches]
    tsc.scatter_update_multi(again, torch.from_numpy(idx),
                             [torch.from_numpy(r) for r in rows])
    for a, g in zip(again, got):
        assert torch.equal(a, g)


def test_backends_agree_on_cpu():
    """On CPU tensors CudaBackend's wrappers take the plain versions, so
    both backends give identical stage outputs."""
    from repro_torch.core.strategy import AttnOutCache
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
    idx = torch.tensor([[1, 4, 29], [0, 7, 8]], dtype=torch.int32)
    a = tbackend.TORCH_BACKEND.gather_norm(h, idx, w, 1e-6)
    b = tbackend.CUDA_BACKEND.gather_norm(h, idx, w, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # score-only drift (cosine_drift), an f32 x against a bf16 cache too
    pc = h.flip(1).to(torch.bfloat16)
    drift = [be.score_drift(AttnOutCache(), h, pc)
             for be in (tbackend.TORCH_BACKEND, tbackend.CUDA_BACKEND)]
    assert torch.equal(drift[0], drift[1])
    assert torch.equal(drift[0], tps.cosine_drift_plain(h, pc))
    # the paged stages: an arena [L=2, P=5, page=3, 32], rows of 6
    arena = h[:, :15].reshape(2, 5, 3, 32).clone()
    pt = torch.tensor([[1, 4], [2, 0]], dtype=torch.int32)
    outs = []
    for be in (tbackend.TORCH_BACKEND, tbackend.CUDA_BACKEND):
        a = arena.clone()
        dense = be.gather_pages(a, pt)
        be.scatter_pages(a, pt, dense * 2)
        be.scatter_rows_paged(a[1], pt, idx, h[:, :3])
        outs.append((dense, a,
                     be.score_drift(AttnOutCache(), h[:, :6], a[0], pt)))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
