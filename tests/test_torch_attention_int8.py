"""The int8 K/V attention of the port: the scales in their own dtype, the
arithmetic of the tensor-core int8 body, and its refusals.

The CUDA body (``attention_i8_wgmma`` in ``csrc/sparse_attention.cu``)
runs only on the card; what it computes is emulated here in float
arithmetic and held to ``sparse_attention_plain``:

- bf16 q times an int8 code is exact in f32 (8 + 8 significant bits), so
  S = q . k_code sums exact products in f32; the scale comes after the
  dot, S[:, j] = (q . k_code[j]) * ks[j] * scale;
- the online softmax runs over tiles of 64 keys in log2 units (exp2), its
  row max ignores NaN as ``fmaxf`` does, masked scores are -inf;
- vs folds into P before the hi/lo split, P'[:, j] = p[:, j] * vs[j] in
  f32, then P' = bf16(P') + bf16(P' - bf16(P')) against the int8 codes of
  V, and l sums the unscaled p.

Tolerance: 2^-7 of the largest output (one bf16 ulp of it), as the card
test holds the kernel to the plain version: the two sum in different
orders and round once to bf16.  A NaN scale must give the plain version's
NaN mask.  The file imports neither jax nor the JAX package.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import sparse_attention as tsa

torch.set_num_threads(1)
BN = 64                       # keys a tile of the body (head_dim <= 128)
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _inputs(b, n, kq, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, kq, h, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.integers(-127, 128, (b, n, kvh, hd))
                             .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((b, n, kvh)) * 0.02)
                               .astype(np.float16)) for _ in range(2))
    pos = torch.from_numpy(rng.integers(0, n, (b, kq)).astype(np.int32))
    return q, k, v, ks, vs, pos


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_int8_body(q, k, v, ks, vs, pos, *, window=0, soft_cap=0.0,
                      kv_len=None):
    """The int8 body's arithmetic in float32 torch ops (module docstring).
    Returns [B, kq, H, hd] bf16."""
    b, kq, h, hd = q.shape
    n, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, kq, kvh, g, hd)
    kc, vc = k.float(), v.float()            # exact codes
    ksf, vsf = ks.float(), vs.float()
    m = torch.full((b, kq, kvh, g), NEG_INF)
    l = torch.zeros((b, kq, kvh, g))
    o = torch.zeros((b, kq, kvh, g, hd))
    lim = (torch.full((b,), n) if kv_len is None
           else torch.minimum(kv_len.long(), torch.tensor(n)))
    for t0 in range(0, n, BN):
        t1 = min(t0 + BN, n)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc[:, t0:t1])
        s = s * ksf[:, t0:t1].permute(0, 2, 1)[:, None, :, None, :]
        if soft_cap > 0.0:
            s = soft_cap * torch.tanh(s * scale / soft_cap) * LOG2E
        else:
            s = s * (scale * LOG2E)
        key = torch.arange(t0, t1)
        ok = key[None, None, :] < lim[:, None, None]
        if window > 0:
            ok = ok & ((pos.long()[:, :, None] - key[None, None, :]).abs()
                       <= window)
        s = torch.where(ok[:, :, None, None, :], s, -math.inf)
        mx = torch.fmax(m, torch.fmax(s.nan_to_num(nan=-math.inf)
                                      .amax(-1), torch.tensor(NEG_INF)))
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp2(m - mx))
        p = torch.exp2(s - mx[..., None])
        l = alpha * l + p.sum(-1)
        pv = p * vsf[:, t0:t1].permute(0, 2, 1)[:, None, :, None, :]
        hi = _bf16(pv)
        lo = _bf16(pv - hi)
        o = alpha[..., None] * o + torch.einsum(
            "bqhgk,bkhd->bqhgd", hi, vc[:, t0:t1]) + torch.einsum(
            "bqhgk,bkhd->bqhgd", lo, vc[:, t0:t1])
        m = mx
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, kq, h, hd).to(torch.bfloat16)


def test_plain_scales_f16_equal_f32():
    """The wrapper passes the cache's f16 scales through uncast: the plain
    version given them equals it given the same scales cast to f32, bit
    for bit (f16 -> f32 is exact), on the dense and the banded grid."""
    q, k, v, ks, vs, pos = _inputs(2, 150, 24, 8, 2, 32, seed=0)
    kw = dict(window=20, soft_cap=30.0,
              kv_len=torch.tensor([150, 77], dtype=torch.int32))
    for qq in (q, q.float()):
        a = tsa.sparse_attention_plain(qq, k, v, pos, k_scale=ks,
                                       v_scale=vs, **kw)
        b = tsa.sparse_attention_plain(qq, k, v, pos, k_scale=ks.float(),
                                       v_scale=vs.float(), **kw)
        assert torch.equal(a, b)
        assert torch.equal(a, tsa.sparse_attention(qq, k, v, pos, k_scale=ks,
                                                   v_scale=vs, **kw))
    band = (torch.tensor([0], dtype=torch.int32), 1, 24)
    a = tsa.sparse_attention_plain(q, k, v, pos, k_scale=ks, v_scale=vs,
                                   block_k=128, band=band, **kw)
    b = tsa.sparse_attention_plain(q, k, v, pos, k_scale=ks.float(),
                                   v_scale=vs.float(), block_k=128,
                                   band=band, **kw)
    assert torch.equal(a, b)


EMULATED = {
    "g6_window_kv_len": dict(shape=(2, 200, 30, 12, 2, 128),
                             kw=dict(window=25), kv_len=[200, 90]),
    "g8_softcap": dict(shape=(2, 150, 17, 16, 2, 128),
                       kw=dict(soft_cap=30.0), kv_len=None),
    "g16_kq1_kv_len0": dict(shape=(2, 130, 1, 16, 1, 128), kw={},
                            kv_len=[130, 0]),
    "hd64_g4": dict(shape=(1, 100, 9, 8, 2, 64), kw=dict(window=40),
                    kv_len=None),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_int8_body_matches_plain(case):
    """The int8 body's arithmetic (scales after the dot, vs folded into P
    before the hi/lo split, exp2 in log2 units, 64-key tiles) matches
    ``sparse_attention_plain`` within 2^-7 of the largest output."""
    c = EMULATED[case]
    q, k, v, ks, vs, pos = _inputs(*c["shape"], seed=len(case))
    kw = dict(c["kw"])
    if c["kv_len"] is not None:
        kw["kv_len"] = torch.tensor(c["kv_len"], dtype=torch.int32)
    got = emulate_int8_body(q, k, v, ks, vs, pos, **kw).float()
    want = tsa.sparse_attention_plain(q, k, v, pos, k_scale=ks, v_scale=vs,
                                      **kw).float()
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2 ** -7 * float(want.abs().max()))
    if c["kv_len"] is not None and 0 in c["kv_len"]:
        assert not got[c["kv_len"].index(0)].any()


def test_emulated_int8_body_nan_scales():
    """A NaN ks[j] poisons column j's scores, a NaN vs[j] P' (p * NaN): the
    emulated body's NaN mask equals the plain version's (the rows of the
    poisoned batch rows), and the clean batch row agrees within 2^-7."""
    q, k, v, ks, vs, pos = _inputs(3, 160, 20, 8, 1, 128, seed=9)
    ks[1, 40:44] = float("nan")
    vs[2, 100:103] = float("nan")
    got = emulate_int8_body(q, k, v, ks, vs, pos)
    want = tsa.sparse_attention_plain(q, k, v, pos, k_scale=ks, v_scale=vs)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(want[1:].isnan().all()) and not bool(want[0].isnan().any())
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=2 ** -7 * float(want[0].abs().max()))


@pytest.mark.cuda
def test_cuda_int8_attention_refuses_head_dim_12():
    """bf16 q with int8 K/V at head_dim 12 (no multiple of 8) raises: no
    body takes it, and none gives way to the f32-q body or the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    q = torch.zeros((1, 4, 2, 12), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 8, 2, 12), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 8, 2), dtype=torch.float16, device=dev)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    before = _lib.launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        tsa.sparse_attention(q, kv, kv, pos, k_scale=sc, v_scale=sc)
    assert _lib.launch_counts() == before
