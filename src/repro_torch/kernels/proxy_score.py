"""Phase-1 kernels: fused identification and the gather + rms_norm epilogue.

``proxy_score`` replaces ``repro/kernels/proxy_score.py:proxy_score``:
``p = x @ W_r`` with f32 accumulation, ``p`` rounded to ``x.dtype``, then
the rowwise cosine of the ROUNDED ``p`` against the cached identifiers
with the norm product floored at ``eps`` (what ``strategy.project``
followed by ``strategy.score`` computes, so unchanged rows tie at 1.0).

``proxy_score_paged`` replaces ``repro/kernels/proxy_score.py:
proxy_score_paged``: the same function with the cached identifiers read
from a pooled page arena [P, page, r] through a page table [B, n_log]
(``csrc/proxy_score.cu`` shares one kernel body between the two, so the
paged result is bitwise the dense result on the gathered pages).

A rank wider than a block holds (r > ``FUSED_R_MAX``: the value, query and
key identifiers project onto kv_dim or q_dim) runs as two launches: the
projection kernel writes the rounded ``p_now`` (counted as
``proxy_score_wide``), and ``cosine_drift`` / ``cosine_drift_paged``
scores it, which is the same function.

``cosine_drift`` replaces ``repro/kernels/proxy_score.py:cosine_drift``:
the projection-free score, the rowwise cosine of x against the cached
identifiers (the attn_in and attn_out identifiers, the incremental
identifier's rescore).  x and the cache may differ in dtype (f32 / bf16).
``cosine_drift_paged`` replaces ``cosine_drift_paged``: the cache read
through a page table, bitwise ``cosine_drift`` on the gathered pages.

``gather_norm`` replaces ``repro/kernels/proxy_score.py:gather_norm``:
the k selected rows of ``h`` (indices clamped to ``[0, N)``) are emitted
raw and rms-normed, ``row * rsqrt(mean(row^2) + eps) * (1 + w)``, in one
pass (rows of at most ``MAX_ROW_BYTES`` bytes on the card: d <= 16384 in
bf16, 8192 in f32).

Each function has a ``*_plain`` PyTorch version beside it.  The wrapper
takes the plain version for tensors on the CPU and launches the CUDA
kernel (``csrc/proxy_score.cu``, ``csrc/gather_norm.cu``) for tensors on
the card; it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.scatter_update import gather_pages_plain


def cosine(p: torch.Tensor, pc: torch.Tensor, eps: float) -> torch.Tensor:
    """Rowwise f32 cosine with the norm PRODUCT floored at eps."""
    p, pc = p.float(), pc.float()
    num = torch.sum(p * pc, dim=-1)
    den = torch.sqrt(torch.sum(p * p, dim=-1) * torch.sum(pc * pc, dim=-1))
    return num / torch.clamp(den, min=eps)


FUSED_R_MAX = 256     # widest rank the fused kernel holds in one block
MAX_ROW_BYTES = 32768  # widest row gather_norm's kernel holds in registers


def cosine_drift_plain(x: torch.Tensor, p_cached: torch.Tensor, *,
                       eps: float = 1e-8) -> torch.Tensor:
    """x, p_cached: [B, N, r] (any float dtypes).  Returns [B, N] f32."""
    return cosine(x, p_cached, eps)


def _drift_operands(x, pc):
    """Contiguous operands the cosine kernel takes, or raise."""
    x, pc = x.contiguous(), pc.contiguous()
    if x.shape[-1] % 8 or x.data_ptr() % 16 or pc.data_ptr() % 16:
        raise ValueError("the cosine_drift kernel needs r % 8 == 0 and "
                         "16-byte aligned operands")
    return x, pc


def cosine_drift(x: torch.Tensor, p_cached: torch.Tensor, *,
                 eps: float = 1e-8) -> torch.Tensor:
    """Projection-free drift scores (see module docstring)."""
    if x.device.type == "cpu":
        return cosine_drift_plain(x, p_cached, eps=eps)
    _lib.require_cuda(x, p_cached)
    if x.dim() != 3 or p_cached.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, p_cached "
                         f"{tuple(p_cached.shape)}")
    x, p_cached = _drift_operands(x, p_cached)
    b, n, r = x.shape
    scores = torch.empty((b, n), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    _lib.check(lib.spa_cosine_drift(
        x.data_ptr(), p_cached.data_ptr(), scores.data_ptr(), b, n, r,
        _lib.dtype_code(x.dtype), _lib.dtype_code(p_cached.dtype), eps,
        _lib.stream_ptr(x)), "cosine_drift")
    _lib.LAUNCHES["cosine_drift"] += 1
    return scores


def cosine_drift_paged_plain(x: torch.Tensor, arena: torch.Tensor,
                             pt: torch.Tensor, *, eps: float = 1e-8
                             ) -> torch.Tensor:
    """Gather the pages dense, then :func:`cosine_drift_plain`."""
    return cosine_drift_plain(x, gather_pages_plain(arena[None], pt)[0],
                              eps=eps)


def cosine_drift_paged(x: torch.Tensor, arena: torch.Tensor,
                       pt: torch.Tensor, *, eps: float = 1e-8
                       ) -> torch.Tensor:
    """x: [B, N, r]; arena: [P, page, r] (one layer, contiguous); pt:
    [B, n_log] with N == n_log * page.  Returns [B, N] f32, bitwise
    :func:`cosine_drift` on the gathered pages."""
    if x.device.type == "cpu":
        return cosine_drift_paged_plain(x, arena, pt, eps=eps)
    _lib.require_cuda(x, arena, pt)
    b, n, r = x.shape
    page = arena.shape[1]
    n_log = pt.shape[1]
    if (arena.dim() != 3 or arena.shape[2] != r or pt.shape[0] != b
            or n != n_log * page):
        raise ValueError(f"shapes x {tuple(x.shape)}, arena "
                         f"{tuple(arena.shape)}, pt {tuple(pt.shape)}")
    if not arena.is_contiguous():
        raise ValueError("the proxy arena must be contiguous")
    x, arena = _drift_operands(x, arena)
    pt = pt.to(torch.int32).contiguous()
    scores = torch.empty((b, n), dtype=torch.float32, device=x.device)
    lib = _lib.load()
    _lib.check(lib.spa_cosine_drift_paged(
        x.data_ptr(), arena.data_ptr(), pt.data_ptr(), scores.data_ptr(),
        b, n, r, page, n_log, _lib.dtype_code(x.dtype),
        _lib.dtype_code(arena.dtype), eps, _lib.stream_ptr(x)),
        "cosine_drift_paged")
    _lib.LAUNCHES["cosine_drift_paged"] += 1
    return scores


def proxy_score_plain(x: torch.Tensor, proxy_mat: torch.Tensor,
                      p_cached: torch.Tensor, *, eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, N, d]; proxy_mat: [d, r]; p_cached: [B, N, r].
    Returns (scores [B, N] f32, p_now [B, N, r] in x.dtype)."""
    p_now = (x.float() @ proxy_mat.float()).to(x.dtype)
    return cosine(p_now, p_cached, eps), p_now


def _check_operands(x, proxy_mat, r, d):
    """Contiguous x and proxy_mat that the kernel takes, or raise."""
    x, proxy_mat = x.contiguous(), proxy_mat.contiguous()
    if x.dtype == torch.bfloat16 and (
            r % 16 or d % 8 or x.data_ptr() % 16
            or proxy_mat.data_ptr() % 16):
        raise ValueError("the bf16 proxy_score kernel needs rank % 16 == 0, "
                         "d % 8 == 0 and 16-byte aligned x and proxy_mat")
    return x, proxy_mat


def _project_wide(x: torch.Tensor, proxy_mat: torch.Tensor) -> torch.Tensor:
    """p_now = x @ proxy_mat rounded to x.dtype, for r > FUSED_R_MAX (the
    projection kernel alone; the caller scores p_now)."""
    b, n, d = x.shape
    r = proxy_mat.shape[1]
    p_now = torch.empty((b, n, r), dtype=x.dtype, device=x.device)
    lib = _lib.load()
    _lib.check(lib.spa_proxy_project(
        x.data_ptr(), proxy_mat.data_ptr(), p_now.data_ptr(), b, n, d, r,
        _lib.dtype_code(x.dtype), _lib.stream_ptr(x)), "proxy_score (wide)")
    _lib.LAUNCHES["proxy_score_wide"] += 1
    return p_now


def proxy_score(x: torch.Tensor, proxy_mat: torch.Tensor,
                p_cached: torch.Tensor, *, eps: float = 1e-8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused projection + drift scoring (see module docstring)."""
    if x.device.type == "cpu":
        return proxy_score_plain(x, proxy_mat, p_cached, eps=eps)
    _lib.require_cuda(x, proxy_mat, p_cached)
    b, n, d = x.shape
    r = proxy_mat.shape[1]
    if proxy_mat.shape != (d, r) or p_cached.shape != (b, n, r):
        raise ValueError(f"shapes x {tuple(x.shape)}, proxy_mat "
                         f"{tuple(proxy_mat.shape)}, p_cached "
                         f"{tuple(p_cached.shape)}")
    if proxy_mat.dtype != x.dtype or p_cached.dtype != x.dtype:
        raise TypeError("x, proxy_mat and p_cached must share one dtype")
    x, proxy_mat = _check_operands(x, proxy_mat, r, d)
    if r > FUSED_R_MAX:
        p_now = _project_wide(x, proxy_mat)
        return cosine_drift(p_now, p_cached, eps=eps), p_now
    p_cached = p_cached.contiguous()
    scores = torch.empty((b, n), dtype=torch.float32, device=x.device)
    p_now = torch.empty((b, n, r), dtype=x.dtype, device=x.device)
    lib = _lib.load()
    _lib.check(lib.spa_proxy_score(
        x.data_ptr(), proxy_mat.data_ptr(), p_cached.data_ptr(),
        scores.data_ptr(), p_now.data_ptr(), b, n, d, r,
        _lib.dtype_code(x.dtype), eps, _lib.stream_ptr(x)), "proxy_score")
    _lib.LAUNCHES["proxy_score"] += 1
    return scores, p_now


def proxy_score_paged_plain(x: torch.Tensor, proxy_mat: torch.Tensor,
                            arena: torch.Tensor, pt: torch.Tensor, *,
                            eps: float = 1e-8
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the pages dense, then :func:`proxy_score_plain`."""
    return proxy_score_plain(x, proxy_mat,
                             gather_pages_plain(arena[None], pt)[0], eps=eps)


def proxy_score_paged(x: torch.Tensor, proxy_mat: torch.Tensor,
                      arena: torch.Tensor, pt: torch.Tensor, *,
                      eps: float = 1e-8
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, N, d]; proxy_mat: [d, r]; arena: [P, page, r] (one layer);
    pt: [B, n_log] with N == n_log * page.  Returns (scores [B, N] f32,
    p_now [B, N, r] in x.dtype), as :func:`proxy_score` on the gathered
    pages."""
    if x.device.type == "cpu":
        return proxy_score_paged_plain(x, proxy_mat, arena, pt, eps=eps)
    _lib.require_cuda(x, proxy_mat, arena, pt)
    b, n, d = x.shape
    r = proxy_mat.shape[1]
    page = arena.shape[1]
    n_log = pt.shape[1]
    if (proxy_mat.shape != (d, r) or arena.dim() != 3
            or arena.shape[2] != r or pt.shape[0] != b
            or n != n_log * page):
        raise ValueError(f"shapes x {tuple(x.shape)}, proxy_mat "
                         f"{tuple(proxy_mat.shape)}, arena "
                         f"{tuple(arena.shape)}, pt {tuple(pt.shape)}")
    if proxy_mat.dtype != x.dtype or arena.dtype != x.dtype:
        raise TypeError("x, proxy_mat and arena must share one dtype")
    if not arena.is_contiguous():
        raise ValueError("the proxy arena must be contiguous")
    x, proxy_mat = _check_operands(x, proxy_mat, r, d)
    if r > FUSED_R_MAX:
        p_now = _project_wide(x, proxy_mat)
        return cosine_drift_paged(p_now, arena, pt, eps=eps), p_now
    pt = pt.to(torch.int32).contiguous()
    scores = torch.empty((b, n), dtype=torch.float32, device=x.device)
    p_now = torch.empty((b, n, r), dtype=x.dtype, device=x.device)
    lib = _lib.load()
    _lib.check(lib.spa_proxy_score_paged(
        x.data_ptr(), proxy_mat.data_ptr(), arena.data_ptr(), pt.data_ptr(),
        scores.data_ptr(), p_now.data_ptr(), b, n, d, r, page, n_log,
        _lib.dtype_code(x.dtype), eps, _lib.stream_ptr(x)),
        "proxy_score_paged")
    _lib.LAUNCHES["proxy_score_paged"] += 1
    return scores, p_now


def gather_norm_plain(h: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: [B, N, d]; idx: [B, k] (clamped to [0, N)); weight: [d].
    Returns (rows [B, k, d], normed [B, k, d]), both in h.dtype."""
    n = h.shape[1]
    ii = idx.long().clamp(0, n - 1)
    rows = torch.gather(h, 1, ii[..., None].expand(-1, -1, h.shape[2]))
    rf = rows.float()
    var = torch.mean(rf * rf, dim=-1, keepdim=True)
    normed = (rf * torch.rsqrt(var + eps)) * (1.0 + weight.float())
    return rows, normed.to(h.dtype)


def gather_norm(h: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gathered-row rms_norm (see module docstring)."""
    if h.device.type == "cpu":
        return gather_norm_plain(h, idx, weight, eps)
    _lib.require_cuda(h, idx, weight)
    b, n, d = h.shape
    k = idx.shape[1]
    if idx.shape[0] != b or weight.shape != (d,):
        raise ValueError(f"shapes h {tuple(h.shape)}, idx "
                         f"{tuple(idx.shape)}, weight {tuple(weight.shape)}")
    if weight.dtype != h.dtype:
        raise TypeError("h and weight must share one dtype")
    if d * h.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"gather_norm: rows of {d * h.element_size()} "
                         f"bytes exceed the kernel's {MAX_ROW_BYTES}")
    h, weight = h.contiguous(), weight.contiguous()
    idx = idx.to(torch.int32).contiguous()
    rows = torch.empty((b, k, d), dtype=h.dtype, device=h.device)
    normed = torch.empty((b, k, d), dtype=h.dtype, device=h.device)
    lib = _lib.load()
    _lib.check(lib.spa_gather_norm(
        h.data_ptr(), idx.data_ptr(), weight.data_ptr(), rows.data_ptr(),
        normed.data_ptr(), b, n, d, k, _lib.dtype_code(h.dtype), eps,
        _lib.stream_ptr(h)), "gather_norm")
    _lib.LAUNCHES["gather_norm"] += 1
    return rows, normed
