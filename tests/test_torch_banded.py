"""PyTorch port vs the JAX package: the banded sparse_attention grid.

The banded grid of a windowed layer on a long canvas: q block ``i`` (512
queries, or all of them when there are fewer) visits only ``n_band`` kv
blocks of 512 from ``starts[i]``.  The port's plain version (what it runs
on the CPU, and the oracle its CUDA kernel is held to on the card) must
give the numbers of the JAX Pallas kernel (``banded=True``, interpret
mode) and of the XLA ``flash_attention`` (``banded``, ``q_span``) on the
same numpy inputs, at N = 4096 with a window of 64:

- gathered queries whose q blocks the band covers (both start clips: the
  first q block starts at kv block 0, the last at the last valid start),
  GQA and MQA, ``kv_len``, soft_cap, int8 K/V with scales, a ragged kq and
  a ragged N;
- a q block wider than the declared ``q_span``: the band does not cover
  its window, and keys outside the band are dropped in both packages;
- contiguous queries (prefill: span = one q block of 512).

Tolerance 1e-5: f32 online softmax, summed in another order.  Where the
band covers the window the banded grid equals the dense grid bit for bit
(a fully masked kv block leaves the softmax state as it was).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sparse_attention import sparse_attention as jsparse
from repro.models.attention import band_width as jband_width
from repro.models.attention import banded_starts as jbanded_starts
from repro.models.attention import flash_attention as jflash

from _torch_parity import np32
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import sparse_attention as tsa
from repro_torch.models import attention as tattn

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
WINDOW = 64

# q blocks of 512: block 0 at positions [0, 1500), block 1 at [2000, 3000)
# (the last q block of a ragged kq holds fewer rows)
CASES = {
    "mqa": dict(kvh=1, h=4),
    "gqa_kv_len_softcap": dict(kvh=2, h=4, kv_len=[4096, 2600],
                               soft_cap=20.0),
    "int8_scales": dict(kvh=1, h=2, quant=True),
    "ragged_kq": dict(kvh=1, h=2, kq=700),
    "ragged_n": dict(kvh=2, h=4, n=4100),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    c = {**dict(b=2, n=4096, kq=1024, hd=32, kv_len=None, soft_cap=0.0,
                quant=False), **case}
    q = rng.standard_normal((c["b"], c["kq"], c["h"], c["hd"])
                            ).astype(np.float32)
    n0 = min(512, c["kq"])
    pos = np.concatenate([
        np.sort(rng.choice(1500, (c["b"], n0)), axis=1),
        np.sort(2000 + rng.choice(1000, (c["b"], c["kq"] - n0)), axis=1)],
        axis=1).astype(np.int32)
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
    return c, q, pos, k, v, ks, vs, kv_len


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _both(c, q, pos, k, v, ks, vs, kv_len, q_span):
    kw = dict(window=WINDOW, soft_cap=c["soft_cap"])
    assert tsa.banded_engages(c["n"], WINDOW, True, q_span)
    want_pallas = jsparse(_j(q), _j(k), _j(v), _j(pos), k_scale=_j(ks),
                          v_scale=_j(vs), kv_len=_j(kv_len), banded=True,
                          q_span=q_span, interpret=True, **kw)
    want_flash = jflash(_j(q), _j(k), _j(v), k_scale=_j(ks), v_scale=_j(vs),
                        q_positions=_j(pos), kv_len=_j(kv_len), banded=True,
                        q_span=q_span, **kw)
    got = tsa.sparse_attention(_t(q), _t(k), _t(v), _t(pos), k_scale=_t(ks),
                               v_scale=_t(vs), kv_len=_t(kv_len),
                               banded=True, q_span=q_span, **kw)
    np.testing.assert_allclose(np32(got), np32(want_pallas), **F32)
    np.testing.assert_allclose(np32(got), np32(want_flash), **F32)
    dense = tsa.sparse_attention_plain(_t(q), _t(k), _t(v), _t(pos),
                                       k_scale=_t(ks), v_scale=_t(vs),
                                       kv_len=_t(kv_len), **kw)
    return got, dense


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_matches_jax_where_the_band_covers(name):
    c, q, pos, k, v, ks, vs, kv_len = _inputs(CASES[name])
    q_span = 1500          # >= the position span of every q block
    starts, n_band, bq = tsa.band_for(_t(pos), c["n"], WINDOW, q_span)
    n_kb = -(-c["n"] // 512)
    assert n_band == jband_width(q_span, WINDOW, 512, n_kb) == 5
    assert bq == min(512, c["kq"])
    # both clips at N = 4096: q block 0 starts at kv block 0, the last
    # block at the last start that keeps n_band blocks inside the canvas
    assert starts.tolist()[0] == 0
    if c["n"] == 4096:
        assert starts.tolist() == [0, n_kb - n_band]
    got, dense = _both(c, q, pos, k, v, ks, vs, kv_len, q_span)
    assert torch.equal(got, dense), "banded must equal dense bit for bit"


def test_banded_drops_keys_outside_a_narrow_band():
    """A declared q_span narrower than q block 0's spread: its band (3 kv
    blocks) ends at 1536 while its window reaches 1563, and both packages
    drop the keys in between."""
    c, q, pos, k, v, ks, vs, kv_len = _inputs(CASES["gqa_kv_len_softcap"])
    got, dense = _both(c, q, pos, k, v, ks, vs, kv_len, q_span=512)
    diff = (got - dense).abs().amax(dim=(2, 3))       # [B, kq]
    assert float(diff[:, :512].max()) > 1e-3, "keys past the band dropped"
    assert torch.equal(got[:, 512:], dense[:, 512:])  # block 1 covered


def test_banded_starts_match_jax():
    rng = np.random.default_rng(1)
    for n, kq in ((4096, 1024), (16384, 3000), (9000, 512)):
        pos = np.sort(rng.integers(0, n, (2, kq)), axis=1).astype(np.int32)
        bq = min(512, kq)
        n_qb = -(-kq // bq)
        padded = np.pad(pos, ((0, 0), (0, n_qb * bq - kq)),
                        constant_values=2 ** 30).reshape(2, n_qb, bq)
        n_kb = -(-n // 512)
        for span in (512, 4096):
            n_band = tattn.band_width(span, WINDOW, 512, n_kb)
            assert n_band == jband_width(span, WINDOW, 512, n_kb)
            want = jbanded_starts(jnp.asarray(padded), WINDOW, n_kb * 512,
                                  n_band, 512)
            got = tattn.banded_starts(torch.from_numpy(padded), WINDOW,
                                      n_kb * 512, n_band, 512)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_len", [None, [4096, 3000]])
def test_banded_prefill_matches_flash(kv_len):
    """Contiguous queries: q blocks span 512 positions, 3 kv blocks each."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4096, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 4096, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4096, 1, 16)).astype(np.float32)
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jflash(_j(q), _j(k), _j(v), window=WINDOW, banded=True,
                  kv_len=_j(kvl))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), window=WINDOW,
                                banded=True, kv_len=_t(kvl))
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    for be in (tbackend.TORCH_BACKEND, tbackend.CUDA_BACKEND):
        via = be.attention(_t(q), _t(k), _t(v), window=WINDOW, banded=True,
                           kv_len=_t(kvl))
        assert torch.equal(via, got)
    dense = tattn.flash_attention(_t(q), _t(k), _t(v), window=WINDOW,
                                  kv_len=_t(kvl))
    assert torch.equal(got, dense)
