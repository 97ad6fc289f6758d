"""The f32-q attention of the port: the arithmetic of the three-pass TF32
body, emulated in float32 torch ops and held to ``sparse_attention_plain``.

The CUDA body (``attention_tf32_wgmma`` in ``csrc/sparse_attention.cu``)
runs only on the card.  What it computes:

- every operand is split into a TF32 pair, hi = tf32(x) and lo = tf32(x -
  hi), where tf32() rounds to 10 mantissa bits, to nearest with ties away
  from zero (``cvt.rna.tf32.f32``'s rounding, which the kernel's
  ``tf32_rna`` does in integer operations: half an ulp added to the
  magnitude bits, the low 13 bits cleared);
- int8 K/V are dequantized to f32 first (code * scale), which is exact
  for f16 scales, so their pair holds the dequantized value exactly;
- S = Q K^T and P V each sum three products, hi.hi + hi.lo + lo.hi, in
  f32 (the product of two TF32 values is exact in f32); the tensor cores
  round their sums toward zero, so S is summed 32 columns at a time and P
  V a tile at a time, each from a fresh accumulator, and those partials
  are added (S) or folded into O = alpha O + P V in f32 rounded to
  nearest;
- the scale, soft cap, masks and online softmax run in f32 over tiles of
  32 keys (expf; masked scores NEG_INF and p = 0; alpha = 0 while the row
  max is still NEG_INF; rows with l == 0 output 0), and P is split after
  the exponentials.

Tolerance: 1e-5 absolute, the f32 limit the card holds the kernel to (the
dropped lo.lo and rounding terms are about 2^-21 of each product).  A
single TF32 pass (hi.hi only) misses it on the same inputs.  The file
imports neither jax nor the JAX package.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import sparse_attention as tsa

torch.set_num_threads(1)
BN = 32                       # keys a tile of the body
NEG_INF = -1e30
F32_TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (finite f32) rounded to TF32 as the kernel's ``tf32_rna``: the
    low 13 bits of the magnitude rounded to nearest, ties away from zero
    (half a TF32 ulp added to the bits, then cleared)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(spec: str, a, b, passes: int = 3) -> torch.Tensor:
    """einsum of two split operands: hi.hi + hi.lo + lo.hi (passes 3), or
    hi.hi alone (passes 1)."""
    (ah, al), (bh, bl) = a, b
    out = torch.einsum(spec, ah, bh)
    if passes == 3:
        out = out + torch.einsum(spec, ah, bl) + torch.einsum(spec, al, bh)
    return out


def _deq(x, scale):
    xf = x.float()
    return xf if scale is None else xf * scale.float()[..., None]


def emulate_tf32_body(q, k, v, pos, *, k_scale=None, v_scale=None,
                      window=0, soft_cap=0.0, kv_len=None, passes=3):
    """The f32-q body's arithmetic (module docstring).  Returns [B, kq, H,
    hd] f32."""
    b, kq, h, hd = q.shape
    n, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qs = split(q.float().reshape(b, kq, kvh, g, hd))
    ks, vs = split(_deq(k, k_scale)), split(_deq(v, v_scale))
    m = torch.full((b, kq, kvh, g), NEG_INF)
    l = torch.zeros((b, kq, kvh, g))
    o = torch.zeros((b, kq, kvh, g, hd))
    lim = (torch.full((b,), n) if kv_len is None
           else torch.minimum(kv_len.long(), torch.tensor(n)))
    for t0 in range(0, n, BN):
        t1 = min(t0 + BN, n)
        s = None
        for c0 in range(0, hd, 32):      # 32-column chunks of S
            part = mm3("bqhgd,bkhd->bqhgk",
                       tuple(x[..., c0:c0 + 32] for x in qs),
                       tuple(x[:, t0:t1, :, c0:c0 + 32] for x in ks), passes)
            s = part if s is None else s + part
        s = s * scale
        if soft_cap > 0.0:
            s = soft_cap * torch.tanh(s / soft_cap)
        key = torch.arange(t0, t1)
        ok = key[None, None, :] < lim[:, None, None]
        if window > 0:
            ok = ok & ((pos.long()[:, :, None] - key[None, None, :]).abs()
                       <= window)
        ok = ok[:, :, None, None, :]
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        o = alpha[..., None] * o + mm3(
            "bqhgk,bkhd->bqhgd", split(p), tuple(x[:, t0:t1] for x in vs),
            passes)
        m = m_new
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, kq, h, hd)


def test_tf32_rounding():
    """tf32() leaves 10 mantissa bits, rounds to nearest with ties away
    from zero, and a pair hi + lo holds x to 2^-22 of |x| across
    exponents."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-20, 20, 100_000))
                         .astype(np.float32))
    hi, lo = split(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    xd, hd_, ld = x.double(), hi.double(), lo.double()
    assert bool(((xd - hd_).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((xd - hd_ - ld).abs() <= 2.0 ** -22 * xd.abs()).all())
    # ties: 1 + 2^-11 (exactly half a TF32 ulp above 1) rounds away from 0
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                  1.0]


def test_int8_times_f16_scale_splits_exactly():
    """Every int8 code times every finite f16 scale is exact in f32 (at
    most 19 significant bits), and its TF32 pair holds it exactly: the
    producer's dequantize-then-split loses nothing."""
    scales = torch.arange(0, 0x7C00, dtype=torch.int32).to(torch.int16) \
        .view(torch.float16)                    # every finite f16 >= 0
    scales = torch.cat([scales, -scales])
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    d = codes.float()[:, None] * scales.float()[None, :]
    assert torch.equal(d.double(),
                       codes.double()[:, None] * scales.double()[None, :])
    hi, lo = split(d)
    assert torch.equal(hi + lo, d)


EDGES = [
    # name, b, n, kq, h, kvh, hd, window, soft_cap, kv_len, quant
    ("hd128 GQA ragged N window soft_cap kv_len", 2, 300, 50, 8, 2, 128, 32,
     30.0, [300, 170], False),
    ("hd64 GQA ragged N window soft_cap kv_len", 2, 200, 70, 4, 2, 64, 40,
     20.0, [131, 200], False),
    ("hd120 GQA 32 on 8 window kv_len", 2, 300, 40, 32, 8, 120, 32, 0.0,
     [300, 170], False),
    ("int8 K/V scales GQA", 2, 160, 24, 4, 2, 32, 0, 0.0, None, True),
    ("kv_len 0 row", 2, 64, 8, 2, 1, 128, 0, 0.0, [64, 0], False),
    ("hd256 G=8 window", 2, 200, 20, 8, 1, 256, 40, 0.0, None, False),
]


def _edge_inputs(b, n, kq, h, kvh, hd, kv_len, quant, seed):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q = f32(b, kq, h, hd)
    kw = {}
    if quant:
        k, v = (torch.from_numpy(rng.integers(-127, 128, (b, n, kvh, hd))
                                 .astype(np.int8)) for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (
            torch.from_numpy((rng.random((b, n, kvh)) * 0.02)
                             .astype(np.float16)) for _ in range(2))
    else:
        k, v = f32(b, n, kvh, hd), f32(b, n, kvh, hd)
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32)
    pos = torch.from_numpy(rng.integers(0, n, (b, kq)).astype(np.int32))
    return q, k, v, pos, kw


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_emulated_tf32_body_matches_plain(edge):
    """Phase 3's f32 edge shapes (GQA, window, soft_cap, ragged kv_len and
    a 0 row, int8 K/V with f16 scales, head_dim 64 / 120 / 128 / 256): the
    emulated three-pass body within 1e-5 of the plain version; a single
    TF32 pass misses that limit."""
    name, b, n, kq, h, kvh, hd, window, soft_cap, kv_len, quant = edge
    q, k, v, pos, kw = _edge_inputs(b, n, kq, h, kvh, hd, kv_len, quant,
                                    seed=len(name))
    kw.update(window=window, soft_cap=soft_cap)
    want = tsa.sparse_attention_plain(q, k, v, pos, **kw)
    got = emulate_tf32_body(q, k, v, pos, **kw)
    err = float((got - want).abs().max())
    assert err <= F32_TOL, f"{name}: {err}"
    if kv_len is not None and 0 in kv_len:
        assert not got[kv_len.index(0)].any()
    one = emulate_tf32_body(q, k, v, pos, passes=1, **kw)
    assert float((one - want).abs().max()) > F32_TOL, \
        "one TF32 pass should miss the f32 limit"


def test_v_key_permutation_matches_a_fragment():
    """The producer writes key 8s + 2m + o of a tile at position 8s + 4o +
    m of V^T's row; the consumer's P fragment holds, in thread t of a
    quad, keys 8s + 2t + o of the S accumulator and passes them as A
    columns t + 4o (a0 / a1: o = 0, a2 / a3: o = 1).  Every key meets its
    own row of V^T exactly once."""
    seen = set()
    for s in range(BN // 8):
        for t in range(4):
            for o in range(2):
                key = 8 * s + 2 * t + o          # the S fragment's key
                a_col = 8 * s + t + 4 * o        # its A fragment column
                m = (key % 8) // 2               # the producer's m, o
                pos = 8 * s + 4 * (key & 1) + m  # its V^T position
                assert a_col == pos
                seen.add(pos)
    assert seen == set(range(BN))
