"""The numerics of the tensor-core SSD scan (``csrc/ssd_chunk.cu``, bf16
path), emulated in torch on the CPU and held against the JAX XLA
``models.ssd.ssd_scan`` and the port's oracle ``ssd_chunk_scan_plain``.

The emulation carries out the kernel's three stages on bf16-valued
inputs: chunk states as ``(w o X)^T B`` with ``w o X`` split into a bf16
hi/lo pair against the exact bf16 B; the f32 pass over the chunks; the
outputs with ``C s_before^T`` (s_before split) and, per 64-row i-tile
(here a smaller tile, so that a chunk has tiles below its diagonal), ``G
= C_I B_J^T`` exact, the decay formed per element on the diagonal tile
(j <= i only) and factored about the j-tile's last row below it, and
``M`` split against X.  A bf16 x bf16 product is exact in f32, so the
emulation's products are f32 matmuls of bf16 values.

Tolerance: 1e-4 of the largest output.  Each split keeps its f32 operand
to about 2^-17 (7.6e-6) of its value, the references differ from each
other only in the order of f32 sums, and the outputs are sums of a few
dozen terms of mixed sign, so the error stays well below 1e-4 of the
largest output; a lone bf16 operand (no lo half) rounds at 2^-9 and
misses it, which the test also asserts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro_torch.kernels import ssd_chunk as tsc

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _split(v, lo=True):
    hi = v.to(BF16).float()
    return hi, ((v - hi).to(BF16).float() if lo else torch.zeros_like(v))


def _emulate(x, dt, la, b, c, chunk, tile, lo=True):
    """The kernel's stages on f32 tensors holding bf16 values (x, b, c)
    and f32 dt, la; rows of a chunk padded with zeros to whole tiles."""
    bsz, t, h, hd = x.shape
    ds = b.shape[-1]
    cs = min(chunk, t)
    n_l, n_t = t // cs, -(-cs // tile)
    pad = n_t * tile - cs

    def rows(v):   # [B, T, ...] -> [B, L, n_t * tile, ...], zero rows added
        v = v.reshape(bsz, n_l, cs, *v.shape[2:])
        return torch.nn.functional.pad(
            v, (0, 0) * (v.dim() - 3) + (0, pad))

    xr, dtr, lar, br, cr = (rows(v) for v in (x, dt, la, b, c))
    live = torch.arange(n_t * tile) < cs                  # rows of the chunk
    la_end = la.reshape(bsz, n_l, cs, h)[:, :, -1]        # [B, L, H]

    # stage 1: S_c = (w o X)^T B, w o X as hi + lo against bf16 B
    w = torch.where(live[None, None, :, None],
                    torch.exp(la_end[:, :, None] - lar) * dtr, 0.0)
    wx_hi, wx_lo = _split(w[..., None] * xr, lo)
    s_c = (torch.einsum("blphd,blps->blhds", wx_hi, br)
           + torch.einsum("blphd,blps->blhds", wx_lo, br))
    # stage 2: the pass, s_before[l + 1] = exp(la_end[l]) s_before[l] + S_c[l]
    s_before = torch.zeros_like(s_c)
    for l in range(n_l - 1):
        s_before[:, l + 1] = (torch.exp(la_end[:, l])[..., None, None]
                              * s_before[:, l] + s_c[:, l])
    # stage 3: y = exp(la_i) (C s_before^T), then M X per j-tile
    sb_hi, sb_lo = _split(s_before, lo)
    y = (torch.einsum("blis,blhds->blihd", cr, sb_hi)
         + torch.einsum("blis,blhds->blihd", cr, sb_lo)) \
        * torch.exp(lar)[..., None]
    tri = torch.tril(torch.ones(tile, tile, dtype=torch.bool))
    for it in range(n_t):
        ii = slice(it * tile, (it + 1) * tile)
        li = live[ii]
        for jt in range(it + 1):
            jj = slice(jt * tile, (jt + 1) * tile)
            g = torch.einsum("blis,bljs->blij", cr[:, :, ii], br[:, :, jj])
            la_i, la_j, dt_j = lar[:, :, ii], lar[:, :, jj], dtr[:, :, jj]
            if jt == it:   # exp(la_i - la_j) for j <= i of live rows only
                ok = (tri & li[:, None])[None, None, :, :, None]
                diff = la_i[:, :, :, None] - la_j[:, :, None, :]
                decay = torch.exp(torch.where(ok, diff, -torch.inf))
                m = (g[..., None] * decay) * dt_j[:, :, None]
            else:          # about la_ref, the j-tile's last row
                ref = la_j[:, :, -1:]
                u = torch.where(li[None, None, :, None],
                                torch.exp(la_i - ref), 0.0)
                v = torch.exp(ref - la_j) * dt_j
                m = (g[..., None] * u[:, :, :, None]) * v[:, :, None]
            m_hi, m_lo = _split(m, lo)
            y[:, :, ii] += (torch.einsum("blijh,bljhd->blihd", m_hi,
                                         xr[:, :, jj])
                            + torch.einsum("blijh,bljhd->blihd", m_lo,
                                           xr[:, :, jj]))
    return y[:, :, :cs].reshape(bsz, t, h, hd)


def _bf16_valued(rng, shape):
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return v.to(BF16).float()


@pytest.mark.parametrize("t,pad_to,chunk,tile", [
    (64, 64, 16, 8),    # 4 chunks of 2 tiles: diagonal and below it
    (50, 64, 16, 8),    # T = 50 padded to the chunk as apply_ssd pads it
    (50, 50, 64, 64),   # one chunk of 50 rows in a ragged 64-row tile
])
def test_split_emulation_matches_references(t, pad_to, chunk, tile):
    bsz, h, hd, ds = 2, 3, 16, 16
    rng = np.random.default_rng(11)
    x = _bf16_valued(rng, (bsz, t, h, hd))
    b = _bf16_valued(rng, (bsz, t, ds))
    c = _bf16_valued(rng, (bsz, t, ds))
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((bsz, t, h)) - 1.0)).astype(np.float32))
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    rows = (0, pad_to - t)
    x, b, c = (torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + rows)
               for v in (x, b, c))
    dt = torch.nn.functional.pad(dt, (0, 0) + rows)
    cs = min(chunk, pad_to)
    steps = dt.numpy() * a[None, None, :]
    la = torch.from_numpy(np.cumsum(
        steps.reshape(bsz, pad_to // cs, cs, h), axis=2,
        dtype=np.float32).reshape(bsz, pad_to, h))

    got = _emulate(x, dt, la, b, c, chunk, tile)[:, :t]
    plain = tsc.ssd_chunk_scan_plain(x, dt, la, b, c, chunk)[:, :t]
    want = torch.from_numpy(np.array(jssd.ssd_scan(
        *(jnp.asarray(v.numpy()) for v in (x, dt)), jnp.asarray(a),
        *(jnp.asarray(v.numpy()) for v in (b, c)), cs)))[:, :t]
    top = float(want.abs().max())
    for name, ref in (("jax ssd_scan", want), ("plain", plain)):
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * top, (name, err, top)
    # the lo halves are what keeps f32 accuracy
    rough = _emulate(x, dt, la, b, c, chunk, tile, lo=False)[:, :t]
    assert float((rough - want).abs().max()) > 1e-4 * top
