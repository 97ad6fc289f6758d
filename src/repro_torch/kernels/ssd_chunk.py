"""The Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060 §6).

Replaces ``repro/kernels/ssd_chunk.py:ssd_chunk_scan`` (the Pallas kernel
that walks the chunks of one head in order with the state S [hd, ds] f32
in VMEM scratch).  The JAX model never calls that kernel: its
``models.ssd.ssd_scan`` runs the same chunked form as XLA einsums and a
``lax.scan`` over chunk states.  The port has no XLA, so here this kernel
IS the scan of ``models.ssd.ssd_scan``.

For each chunk of ``cs = min(chunk, T)`` steps, per batch row and head:

  y_intra = ((C B^T) ∘ exp(la_i - la_j) ∘ 1[j<=i] ∘ dt_j) X
  y_inter = (C S^T) ∘ exp(la_i)
  S'      = exp(la_end) S + X^T (exp(la_end - la_j) dt_j ∘ B)

with ``la`` the in-chunk cumulative sum of ``dt * a`` (reset every chunk),
S from zero, ``b`` and ``c`` shared by all heads (ngroups = 1) and f32
arithmetic throughout; y is cast to x's dtype.

``ssd_chunk_scan_plain`` is the chunked form term for term with the JAX
``ssd_scan`` (the oracle); ``ssd_scan_ref`` the sequential per-step
recurrence (for tests).  The wrapper takes the plain version for CPU
tensors and launches ``csrc/ssd_chunk.cu`` for CUDA ones: chunk states in
parallel, a pass over the chunks, then the outputs (three kernels, counted
as one launch), with the chunk states in an f32 workspace
[B, T / cs, H, 64, 128] that the wrapper allocates (f32 inputs: [B, T / cs,
H, 2, 64, 128], the pass writing each state as a TF32 hi / lo pair).  Both
dtypes run on the tensor cores: bf16 products, and f32 ones in three-pass
TF32 (``tests/test_torch_ssd_tf32.py`` emulates their arithmetic).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

# the kernel's widths: head_dim and d_state at most these (Mamba2-370m's);
# the workspace holds each chunk state padded to them
MAX_HEAD_DIM = 64
MAX_D_STATE = 128


def ssd_chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, la: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """x [B, T, H, hd]; dt, la [B, T, H]; b, c [B, T, ds] -> y [B, T, H, hd]
    in x.dtype (f32 arithmetic).  T must be a multiple of min(chunk, T)."""
    bsz, t, h, hd = x.shape
    ds = b.shape[-1]
    cs = _chunk_of(t, chunk)
    ncs = t // cs
    xr = x.float().reshape(bsz, ncs, cs, h, hd)
    dtr = dt.float().reshape(bsz, ncs, cs, h)
    lar = la.float().reshape(bsz, ncs, cs, h)
    br = b.float().reshape(bsz, ncs, cs, ds)
    cr = c.float().reshape(bsz, ncs, cs, ds)
    la_end = lar[:, :, -1, :]                             # [B,L,H]

    # intra-chunk (quadratic, masked after the exp, as the reference)
    g = torch.einsum("blis,bljs->blij", cr, br)           # [B,L,cs,cs]
    decay = torch.exp(lar[:, :, :, None, :] - lar[:, :, None, :, :])
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=x.device))
    m = g[..., None] * torch.where(mask[None, None, :, :, None], decay,
                                   torch.zeros((), device=x.device))
    del decay
    m = m * dtr[:, :, None, :, :]                         # weight by dt_j
    y_intra = torch.einsum("blijh,bljhd->blihd", m, xr)
    del m

    # chunk states, then the inter-chunk recurrence over L
    w = torch.exp(la_end[:, :, None, :] - lar) * dtr      # [B,L,cs,H]
    s_chunk = torch.einsum("bljh,bljhd,bljs->blhds", w, xr, br)
    a_tot = torch.exp(la_end)                             # [B,L,H]
    s = torch.zeros((bsz, h, hd, ds), dtype=torch.float32, device=x.device)
    s_before = torch.empty_like(s_chunk)
    for l in range(ncs):
        s_before[:, l] = s
        s = a_tot[:, l, :, None, None] * s + s_chunk[:, l]

    y_inter = torch.einsum("blis,blhds->blihd", cr, s_before)
    y_inter = y_inter * torch.exp(lar)[..., None]         # decay to pos i
    return (y_intra + y_inter).reshape(bsz, t, h, hd).to(x.dtype)


def ssd_chunk_scan_cost(x_shape, ds: int, chunk: int, x_itemsize: int):
    """(FLOPs, bytes) of one ``ssd_chunk_scan`` of x [B, T, H, hd] with a
    state of ``ds``, counted as one fused op (``launch/hlo_cost``): the
    plain version's four matrix products (C B^T within a chunk, its
    weighted sum over x, the chunk states, their read-out), 2 * B * T *
    (cs * ds + cs * H * hd + 2 * H * hd * ds) with cs the chunk, and one
    read of every operand (dt, la f32; b, c in x's dtype) and one write of
    y, as the kernel moves them."""
    bsz, t, h, hd = x_shape
    cs = _chunk_of(t, chunk)
    flops = 2.0 * bsz * t * (cs * ds + cs * h * hd + 2 * h * hd * ds)
    byts = (2.0 * bsz * t * h * hd * x_itemsize      # x in, y out
            + 2.0 * bsz * t * h * 4                  # dt, la
            + 2.0 * bsz * t * ds * x_itemsize)       # b, c
    return flops, byts


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
    """The sequential SSD recurrence (one step at a time, no chunks):
    x [B, T, H, hd], dt [B, T, H], a [H], bmat, cmat [B, T, ds]."""
    bsz, t, h, hd = x.shape
    ds = bmat.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = bmat.float(), cmat.float(), a.float()
    s = torch.zeros((bsz, h, hd, ds), dtype=torch.float32, device=x.device)
    ys = torch.empty((bsz, t, h, hd), dtype=torch.float32, device=x.device)
    for i in range(t):
        a_t = torch.exp(dtf[:, i] * af[None, :])                  # [B,H]
        s = s * a_t[:, :, None, None] + torch.einsum(
            "bh,bhd,bs->bhds", dtf[:, i], xf[:, i], bf[:, i])
        ys[:, i] = torch.einsum("bs,bhds->bhd", cf[:, i], s)
    return ys.to(x.dtype)


def _chunk_of(t: int, chunk: int) -> int:
    cs = min(chunk, t)
    if cs <= 0 or t % cs:
        raise ValueError(f"T = {t} is no multiple of the chunk {cs}: the "
                         "caller pads the sequence")
    return cs


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, la: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """x [B, T, H, hd] (f32 or bf16); dt, la [B, T, H] f32; b, c [B, T, ds]
    in x's dtype -> y [B, T, H, hd] in x's dtype (see module docstring).
    Raises unless T is a multiple of min(chunk, T)."""
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} must be [B, T, H, hd]")
    bsz, t, h, hd = x.shape
    for name, v in (("dt", dt), ("la", la)):
        if v.shape != (bsz, t, h):
            raise ValueError(f"{name} {tuple(v.shape)} must be {(bsz, t, h)}")
    if b.shape != c.shape or b.shape[:2] != (bsz, t) or b.dim() != 3:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"be one [{bsz}, {t}, ds] shape")
    cs = _chunk_of(t, chunk)
    if all(v.device.type == "cpu" for v in (x, dt, la, b, c)):
        return ssd_chunk_scan_plain(x, dt, la, b, c, cs)
    _lib.require_cuda(x, dt, la, b, c)
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype}, b {b.dtype}, c {c.dtype}: pass "
                        "one dtype")
    if dt.dtype != torch.float32 or la.dtype != torch.float32:
        raise TypeError(f"dt and la must be float32, got {dt.dtype}, "
                        f"{la.dtype}")
    ds = b.shape[-1]
    if hd > MAX_HEAD_DIM or ds > MAX_D_STATE:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"d_state <= {MAX_D_STATE}, got {hd} and {ds}")
    code = _lib.dtype_code(x.dtype)
    x, dt, la = x.contiguous(), dt.contiguous(), la.contiguous()
    b, c = b.contiguous(), c.contiguous()
    y = torch.empty_like(x)
    # the chunk states (none when the sequence is one chunk); f32 keeps
    # each as a TF32 pair, twice the floats
    n_chunks = t // cs
    pairs = 2 if x.dtype == torch.float32 else 1
    ws = (torch.empty(bsz * n_chunks * h * pairs * MAX_HEAD_DIM * MAX_D_STATE,
                      dtype=torch.float32, device=x.device)
          if n_chunks > 1 else None)
    lib = _lib.load()
    _lib.check(lib.spa_ssd_chunk_scan(
        x.data_ptr(), dt.data_ptr(), la.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(),
        bsz, t, h, hd, ds, cs, code, _lib.stream_ptr(x)), "ssd_chunk_scan")
    _lib.LAUNCHES["ssd_chunk_scan"] += 1
    return y
