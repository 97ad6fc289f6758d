"""The numerics of the one-pass RG-LRU scan (``csrc/rglru_scan.cu``),
emulated in torch on the CPU and held against the port's oracle
``rglru_scan_plain`` and the JAX Pallas ``rglru_scan`` in interpret mode.

The emulation carries out what the kernel computes, tile by tile: each
chunk of 64 steps forms its affine aggregate (P_j, the product of its a in
step order, and E_j, its end state from h = 0), the carries chain as
S_{j+1} = (P_j * S_j) + E_j from S_0 = 0, and each chunk runs the
recurrence again from S_j.  Every step rounds a * h to f32 and then adds
b (two f32 torch ops, no fused multiply-add), as the kernel does with
``__fmul_rn`` / ``__fadd_rn``.  The kernel's look-back may start a chunk's
walk from the published S of any earlier chunk; the emulation walks from
every such chunk and asserts the same bits, which is why the kernel gives
the same result on every run.

Tolerances: f32 within 1e-5 absolute plus 1e-5 of each element (the carry
reassociates the sequential sum at chunk boundaries, ~1e-7 relative);
bf16 outputs within one bf16 ulp (2^-7 of each element) plus 1e-5, since
a carry that differs in its last f32 bit can round h to the neighbouring
bf16 value.  The first chunk has no carry and matches bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as jrglru_scan

from _torch_parity import np32
from repro_torch.kernels import rglru_scan as trs

torch.set_num_threads(1)
CHUNK = 64   # csrc/rglru_scan.cu kChunk
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _step(a, h, b):
    return torch.add(torch.mul(a, h), b)   # two roundings, as the kernel


def _aggregates(af, bf):
    """(P, E) of every chunk: [B, n_chunks, d] each, f32."""
    bsz, t, d = af.shape
    n = -(-t // CHUNK)
    prod = torch.ones((bsz, n, d))
    last = torch.zeros((bsz, n, d))
    for j in range(n):
        for i in range(j * CHUNK, min(t, (j + 1) * CHUNK)):
            prod[:, j] = torch.mul(af[:, i], prod[:, j])
            last[:, j] = _step(af[:, i], last[:, j], bf[:, i])
    return prod, last


def _starts(prod, last):
    """S_j of every chunk by the chained carry from S_0 = 0."""
    s = torch.zeros_like(prod)
    for j in range(1, prod.shape[1]):
        s[:, j] = _step(prod[:, j - 1], s[:, j - 1], last[:, j - 1])
    return s


def _walk(prod, last, s, m, j):
    """S_j as a look-back computes it: from the published S_{m+1} of chunk
    m (m = -1: from S_0 = 0) through the aggregates of chunks m+1 .. j-1."""
    h = _step(prod[:, m], s[:, m], last[:, m]) if m >= 0 \
        else torch.zeros_like(s[:, 0])
    for k in range(m + 1, j):
        h = _step(prod[:, k], h, last[:, k])
    return h


def _emulate(a, b):
    """The kernel's result for a, b [B, T, d] (f32 or bf16)."""
    af, bf = a.float(), b.float()
    prod, last = _aggregates(af, bf)
    s = _starts(prod, last)
    out = torch.empty_like(af)
    for j in range(prod.shape[1]):
        h = s[:, j]
        for i in range(j * CHUNK, min(a.shape[1], (j + 1) * CHUNK)):
            h = _step(af[:, i], h, bf[:, i])
            out[:, i] = h
    return out.to(a.dtype)


def _inputs(bsz, t, d, dtype, seed):
    rng = np.random.default_rng(seed)
    # decays in [0.9, 1): a chunk keeps a good part of its start state, so
    # the carries decide the result
    a = (1.0 - 0.1 * rng.random((bsz, t, d))).astype(np.float32)
    b = (0.1 * rng.standard_normal((bsz, t, d))).astype(np.float32)
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("t,d", [(300, 70), (40, 24), (64, 8), (129, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flip", [False, True])
def test_lookback_emulation_matches_references(t, d, dtype, flip):
    """Ragged T and d, T below one chunk, one chunk exactly, one step past
    two; forward and flipped (the backward direction of the bidirectional
    block), against the sequential plain loop and the Pallas kernel."""
    a, b = _inputs(2, t, d, dtype, seed=t + d)
    if flip:
        a, b = torch.flip(a, dims=(1,)), torch.flip(b, dims=(1,))
    got = _emulate(a, b)
    assert got.dtype == dtype and got.shape == a.shape
    plain = trs.rglru_scan_plain(a, b)
    np.testing.assert_allclose(np32(got), np32(plain), **TOL[dtype])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for row in range(2):
        want = jrglru_scan(jnp.asarray(np32(a[row]), jdt),
                           jnp.asarray(np32(b[row]), jdt), interpret=True,
                           chunk=32, block_d=32)
        np.testing.assert_allclose(np32(got[row]), np32(want),
                                   **TOL[dtype])
    # the first chunk carries nothing in: bit for bit the sequential loop
    n0 = min(t, CHUNK)
    assert torch.equal(got[:, :n0], plain[:, :n0])


def test_lookback_start_is_schedule_free():
    """Walking from any earlier chunk's published S gives S_j bit for bit
    (the look-back finds a different chunk on every run), and chunk 0
    publishes S_1 = (P_0 * 0) + E_0 = E_0."""
    a, b = _inputs(2, 6 * CHUNK + 5, 16, torch.float32, seed=3)
    prod, last = _aggregates(a, b)
    s = _starts(prod, last)
    n = prod.shape[1]
    for j in range(1, n):
        for m in range(-1, j):
            assert torch.equal(_walk(prod, last, s, m, j), s[:, j]), (j, m)
    assert torch.equal(_step(prod[:, 0], torch.zeros_like(s[:, 0]),
                             last[:, 0]), last[:, 0])
    # and the chained carries are not the sequential loop's bits, which is
    # why the tolerances above are not zero
    seq = trs.rglru_scan_plain(a, b)
    assert not torch.equal(_emulate(a, b), seq)
