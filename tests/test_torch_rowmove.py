"""The SPA layer step's row movers, ``scatter_update_multi`` and
``gather_norm``, at the shapes their CUDA kernels (``csrc/scatter_update.cu``,
``csrc/gather_norm.cu``) dispatch on, on the CPU.

- ``scatter_update_multi_plain`` against the JAX Pallas
  ``scatter_update_multi`` in interpret mode: 512-byte rows (one kv head
  of 256 in bf16), one commit that mixes 16-byte-aligned, 64-byte, 10-byte
  and 2-byte rows, k = 1 and k = 7, unsorted indices with -1, N and 2N
  among them.  A copy: bit for bit.
- ``plan_units``, the kernel's host-side work split: at the phase-3 and
  hybrid commit shapes every (b, j, buffer) byte range is covered by
  exactly one unit, units are 16-byte aligned, of equal size within a row
  and no wider than ``UNIT_MAX``, the warps' ranges cover each CTA's, and
  none spans more than ``WARP_ROWS`` rows (one index a lane).
- ``gather_norm_plain`` against the Pallas ``gather_norm`` in interpret
  mode at d in {120, 1000, 4096}, bf16 and f32, indices clamped both ways:
  raw rows bit for bit, normed rows within one bf16 ulp (f32: 1e-5).
- A torch emulation of the kernel's sum of squares (each thread over its
  vectors in order, a butterfly of warp shuffles, the warps of a row in
  index order), at every number of warps a row the kernel may take,
  within one bf16 ulp of the Pallas kernel's normed rows and of
  ``gather_norm_plain`` (f32: 1e-5); in bf16 the squares are exact in
  f32, so the emulation's sums are the kernel's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.proxy_score import gather_norm as jgather_norm
from repro.kernels.scatter_update import (scatter_update_multi as
                                          jscatter_multi)

from _torch_parity import np32
from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import scatter_update as tsc

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """numpy float array -> (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np32(j)).to(_TORCH[jnp.dtype(dtype).name])


def _as_torch(a):
    """numpy or jax array (bf16 included) -> torch tensor, same bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _scatter_both(caches, rows, idx):
    want = jscatter_multi([jnp.asarray(c) for c in caches], jnp.asarray(idx),
                          [jnp.asarray(r) for r in rows], interpret=True,
                          block_k=4)
    got = [_as_torch(c) for c in caches]
    tsc.scatter_update_multi_plain(got, torch.from_numpy(idx),
                                   [_as_torch(r) for r in rows])
    for g, w in zip(got, want):
        assert torch.equal(g, _as_torch(w))


def _idx(rng, b, n, k, extra=()):
    """Unsorted distinct rows of [0, n) per batch row, with ``extra``
    out-of-range entries (that must drop) written over the first ones."""
    idx = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(
        np.int32)
    for t, v in enumerate(extra):
        idx[t % b, t // b] = v
    return idx


@pytest.mark.parametrize("k", [1, 7, 12])
def test_scatter_512_byte_rows_match_pallas(k):
    """K and V rows of one kv head of 256 in bf16: 512 bytes, a warp's
    16-byte moves, the hybrid's commit."""
    rng = np.random.default_rng(10 + k)
    b, n = 2, 40
    bf16 = jnp.bfloat16
    caches = [np.asarray(jnp.asarray(rng.standard_normal((b, n, 1, 256)),
                                     bf16)) for _ in range(2)]
    rows = [np.asarray(jnp.asarray(rng.standard_normal((b, k, 1, 256)),
                                   bf16)) for _ in range(2)]
    extra = (-1, n, 2 * n) if k > 2 else (-1,)
    _scatter_both(caches, rows, _idx(rng, b, n, k, extra))


@pytest.mark.parametrize("k", [1, 7])
def test_scatter_mixed_widths_match_pallas(k):
    """One commit of int8 K rows (64 bytes), f16 scale rows (4 bytes), a
    10-byte bf16 row, a 2-byte f16 scale row, 192-byte f32 rows and
    16-byte-aligned bf16 rows: the bulk, 4-byte and 1-byte paths of the
    kernel in one launch; -1, N and 2N drop."""
    rng = np.random.default_rng(20 + k)
    b, n = 3, 33
    bf16 = jnp.bfloat16

    def bufs(m):
        return [rng.integers(-127, 128, (b, m, 2, 32)).astype(np.int8),
                (rng.random((b, m, 2)) * 0.1).astype(np.float16),
                np.asarray(jnp.asarray(rng.standard_normal((b, m, 5)),
                                       bf16)),
                (rng.random((b, m)) * 0.1).astype(np.float16),
                rng.standard_normal((b, m, 48)).astype(np.float32),
                np.asarray(jnp.asarray(rng.standard_normal((b, m, 4, 8)),
                                       bf16))]

    caches, rows = bufs(n), bufs(k)
    extra = (-1, n, 2 * n) if k > 1 else (2 * n,)
    _scatter_both(caches, rows, _idx(rng, b, n, k, extra))


def unit_span(plan, row_bytes, k, u):
    """(buffer, b, j, first byte, end byte) of the units u (an int64
    tensor), decoded as csrc/scatter_update.cu's cursor walks them: row
    ``u // per_row``, unit ``q = u % per_row`` of it, buffer t the last
    with ``first[t] <= q``."""
    r, q = torch.div(u, plan.per_row, rounding_mode="floor"), u % plan.per_row
    first = torch.tensor(plan.first)
    t = torch.searchsorted(first, q, right=True) - 1
    chunk = torch.tensor(plan.chunk)[t]
    lo = (q - first[t]) * chunk
    hi = torch.minimum(lo + chunk, torch.tensor(row_bytes)[t])
    return t, torch.div(r, k, rounding_mode="floor"), r % k, lo, hi


# (row bytes of each buffer, B, k): the commits of chip_smoke.py phase 3
PLAN_CASES = {
    "llada_kv_k128": ((8192, 8192), 4, 128),
    "llada_kv_k16": ((8192, 8192), 4, 16),
    "llada_h_proxy": ((8192, 256), 4, 128),
    "int8_kv_scales": ((4096, 4096, 64, 64), 4, 128),
    "int8_h_scale_proxy": ((4096, 2, 256), 4, 128),
    "hybrid_kv_k4096": ((512, 512), 2, 4096),
    "hybrid_h_proxy_k4096": ((8192, 256), 2, 4096),
    "mixed_k7": ((64, 4, 10, 2, 192, 64), 3, 7),
    "f32_h_wide": ((16384, 512, 0), 4, 128),
    "one_row": ((8192,), 1, 1),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("n_sm", [132, 7])
def test_plan_units_covers_every_byte_once(case, n_sm):
    row_bytes, b, k = PLAN_CASES[case]
    plan = tsc.plan_units(row_bytes, b * k, n_sm)
    assert plan.units == b * k * plan.per_row
    assert plan.grid * plan.upc >= plan.units > (plan.grid - 1) * plan.upc
    assert plan.upw * tsc.WARPS >= plan.upc
    assert plan.grid <= max(tsc.CTAS_PER_SM * n_sm,
                            -(-plan.units // (tsc.WARPS * (
                                (tsc.WARP_ROWS - 1) * plan.per_row + 1))))
    for c in range(plan.grid):
        lo, hi = c * plan.upc, min((c + 1) * plan.upc, plan.units)
        assert lo < hi
        for w in range(tsc.WARPS):
            w_lo = lo + w * plan.upw
            w_hi = min(w_lo + plan.upw, hi)
            if w_lo < w_hi:
                assert ((w_hi - 1) // plan.per_row - w_lo // plan.per_row
                        < tsc.WARP_ROWS)
    t, bb, j, a, e = unit_span(plan, row_bytes, k, torch.arange(plan.units))
    assert bool((a % 16 == 0).all()) and bool((e > a).all())
    assert bool((e - a <= tsc.UNIT_MAX).all())
    for buf, rb in enumerate(row_bytes):
        mine = t == buf
        if rb == 0:
            assert not bool(mine.any())
            continue
        # every byte of every (b, j) row exactly once, in equal units
        c = plan.chunk[buf]
        per = -(-rb // c)
        slot = (bb[mine] * k + j[mine]) * per + a[mine] // c
        counts = torch.bincount(slot, minlength=b * k * per)
        assert counts.numel() == b * k * per and bool((counts == 1).all())
        assert bool(((a[mine] % c) == 0).all())
        ends = e[mine][a[mine] // c == per - 1]
        assert bool((ends == rb).all())
        full = a[mine] // c < per - 1
        assert bool((e[mine][full] - a[mine][full] == c).all())


def test_copy_width():
    """The widest move every address, stride and row width allows."""
    assert tsc.copy_width(1 << 20, 256, 8192 * 512, 8192, 8192) == 16
    assert tsc.copy_width(1 << 20, 256, 64 * 7, 64, 64) == 16
    assert tsc.copy_width(1 << 20, 4, 10 * 33, 10, 10) == 1
    assert tsc.copy_width(1 << 20, 256, 4 * 33, 4, 4) == 4
    assert tsc.copy_width(1 << 20, 256, 2 * 33, 2, 2) == 1
    assert tsc.copy_width((1 << 20) + 8, 256, 8192, 8192, 8192) == 4


@pytest.mark.parametrize("d", [120, 1000, 4096])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_norm_widths_match_pallas(d, dtype):
    rng = np.random.default_rng(d)
    h, th = _pair(rng.standard_normal((2, 24, d)), dtype)
    w, tw = _pair(rng.standard_normal((d,)) * 0.1, dtype)
    idx = np.array([[3, 23, -2, 0, 17, 40, 5], [20, 1, 100, -7, 9, 9, 2]],
                   np.int32)                      # clamps both ways
    rows, normed = jgather_norm(h, jnp.asarray(idx), w, 1e-6,
                                interpret=True, block_g=4)
    t_rows, t_normed = tps.gather_norm_plain(th, torch.from_numpy(idx), tw,
                                             1e-6)
    np.testing.assert_array_equal(np32(t_rows), np32(rows))
    np.testing.assert_allclose(np32(t_normed), np32(normed),
                               **(F32 if dtype == jnp.float32 else BF16))


# csrc/gather_norm.cu: the most vectors a thread holds, by vector bytes
_VPL = {16: 8, 4: 32, 2: 64}


def min_warps(d, es):
    """The fewest warps a row takes in csrc/gather_norm.cu (the kernel may
    double them, up to 8, for a call with few rows)."""
    row_bytes = d * es
    v = 16 if row_bytes % 16 == 0 else 4 if row_bytes % 4 == 0 else 2
    warps = 1
    while warps * 32 * _VPL[v] < row_bytes // v:
        warps *= 2
    return warps


def emulate_gather_norm(h, idx, w, eps, warps):
    """The kernel's arithmetic at ``warps`` warps a row: vector width V
    from the row's bytes (16, 4 or 2), thread t summing f^2 over vectors
    t, t + 32 warps, ... and their elements in order, a xor butterfly (16,
    8, 4, 2, 1) in each warp, then the warps in index order; rsqrt(sum / d
    + eps); normed rounded once from f32."""
    b, n, d = h.shape
    es = h.element_size()
    row_bytes = d * es
    v = 16 if row_bytes % 16 == 0 else 4 if row_bytes % 4 == 0 else 2
    e = v // es
    gs = 32 * warps
    vpl = -(-(row_bytes // v) // gs)
    ii = idx.long().clamp(0, n - 1)
    rows = torch.gather(h, 1, ii[..., None].expand(-1, -1, d))
    x = rows.float().reshape(-1, d)
    pad = torch.zeros(x.shape[0], vpl * gs * e)
    pad[:, :d] = x
    lanes = pad.view(-1, vpl, gs, e)
    acc = torch.zeros(x.shape[0], gs)
    for q in range(vpl):
        for el in range(e):
            f = lanes[:, q, :, el]
            acc = acc + f * f
    acc = acc.view(-1, warps, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lane ^ o]
    assert torch.equal(acc, acc[:, :, :1].expand_as(acc)), \
        "every lane of a warp holds the same sum"
    total = torch.zeros(x.shape[0])
    for i in range(warps):
        total = total + acc[:, i, 0]
    inv = torch.rsqrt(total / d + eps)
    normed = (x * inv[:, None]) * (1.0 + w.float())
    return rows, normed.to(h.dtype).view(b, -1, d)


# d, then the warps a row takes in bf16 and in f32
@pytest.mark.parametrize("d,w_bf16,w_f32", [
    (120, 1, 1), (1000, 1, 1), (4096, 2, 4), (8192, 4, 8), (1001, 1, 1),
    (4098, 4, 8)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_norm_kernel_order_matches_pallas(d, w_bf16, w_f32, dtype):
    """The emulated sum order against the Pallas kernel (interpret mode)
    and the plain version, at each number of warps a row may take: at
    least one up to 4 KB, more beyond (the warps summed in index order),
    and the 4- and 2-byte vector paths (d = 4098 and 1001 in bf16; 4098
    and 1001 in f32 take 4 bytes)."""
    rng = np.random.default_rng(d + 7)
    h, th = _pair(rng.standard_normal((2, 10, d)) * 3.0, dtype)
    w, tw = _pair(rng.standard_normal((d,)) * 0.1, dtype)
    idx = np.array([[3, 9, -2, 0, 7], [20, 1, 4, -7, 9]], np.int32)
    _, normed = jgather_norm(h, jnp.asarray(idx), w, 1e-6, interpret=True,
                             block_g=5)
    least = min_warps(d, th.element_size())
    assert least == (w_f32 if dtype == jnp.float32 else w_bf16)
    tol = F32 if dtype == jnp.float32 else BF16
    p_rows, p_normed = tps.gather_norm_plain(th, torch.from_numpy(idx), tw,
                                             1e-6)
    warps = least
    while warps <= 8:
        rows, emu = emulate_gather_norm(th, torch.from_numpy(idx), tw, 1e-6,
                                        warps)
        np.testing.assert_allclose(np32(emu), np32(normed), **tol)
        assert torch.equal(rows, p_rows)
        np.testing.assert_allclose(np32(emu), np32(p_normed), **tol)
        warps *= 2
