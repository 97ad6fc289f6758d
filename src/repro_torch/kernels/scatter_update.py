"""Cache-commit kernels: dense multi-buffer row commits and the paged copies.

Replaces ``repro/kernels/scatter_update.py:scatter_update_multi``: the
rows ``[B, k, ...]`` of every buffer of one commit (K + V (+ scales), then
H (+ scale) + proxy) are written at ``idx [B, k]`` into their ``[B, N, ...]``
cache buffers IN PLACE, in one launch; indices outside ``[0, N)`` are
dropped and any index order is correct.  The Pallas kernel's batching of
runs of 8 consecutive indices into one DMA is a TPU transfer detail whose
result this reproduces, not its scheme.

Where the JAX function returns new arrays, the port mutates the buffers it
is given (and returns them): callers that need a "before" copy clone it.

``scatter_update_multi_plain`` is the PyTorch version (advanced-index
writes of the in-range rows); the wrapper takes it for CPU tensors and
launches ``csrc/scatter_update.cu`` for CUDA ones.

Paged cache (``csrc/paged.cu``; replaces ``gather_pages``,
``scatter_pages`` and ``scatter_rows_paged`` of
``repro/kernels/scatter_update.py``): cache rows live in a pooled arena of
fixed-size pages, and logical canvas row n of batch row b is physical row
``pt[b, n // page] * page + n % page``.  Physical page 0 is the pool's zero
page: never written, so every logical page past a row's ``kv_len`` can map
to it.

  gather_pages       arena [L, P, page, ...] -> dense [L, B, n_log*page, ...]
  scatter_pages      the inverse, into the arena in place; page-0 writes drop
  scatter_rows_paged rows [B, k, ...] at logical rows idx [B, k] into ONE
                     layer's arena [P, page, ...] in place; idx < 0,
                     idx // page >= n_log and page-0 rows drop

Each has a ``*_plain`` version written the way the JAX package's
``XlaBackend`` writes it, taken for CPU tensors.  Page tables must hold
page ids in [0, P).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _lib

MAX_BUFFERS = 8          # csrc/scatter_update.cu: buffers per launch


def _check_shapes(caches, idx, rows):
    if len(caches) != len(rows) or not caches:
        raise ValueError("need one row payload per cache buffer")
    b, k = idx.shape
    for c, r in zip(caches, rows):
        if c.shape[0] != b or r.shape[:2] != (b, k) \
                or r.shape[2:] != c.shape[2:]:
            raise ValueError(f"cache {tuple(c.shape)} vs rows "
                             f"{tuple(r.shape)} at idx {tuple(idx.shape)}")
        if c.shape[1] != caches[0].shape[1]:
            raise ValueError("every buffer of one commit has the same N")


def scatter_update_multi_plain(caches: Sequence[torch.Tensor],
                               idx: torch.Tensor,
                               rows: Sequence[torch.Tensor]
                               ) -> Tuple[torch.Tensor, ...]:
    """caches[i]: [B, N, ...] (written in place); idx: [B, k]; rows[i]:
    [B, k, ...].  Out-of-range indices are dropped."""
    _check_shapes(caches, idx, rows)
    n = caches[0].shape[1]
    ii = idx.long()
    ok = (ii >= 0) & (ii < n)
    bb = torch.arange(ii.shape[0], device=ii.device)[:, None].expand_as(ii)
    bsel, isel = bb[ok], ii[ok]
    for c, r in zip(caches, rows):
        c[bsel, isel] = r[ok].to(c.dtype)
    return tuple(caches)


def _row_view(t: torch.Tensor) -> torch.Tensor:
    """[B, N, *f] -> [B, N, F] without a copy (rows must be contiguous)."""
    v = t.reshape(t.shape[0], t.shape[1], -1)
    if v.stride(2) != 1 or v.data_ptr() != t.data_ptr():
        raise ValueError("buffer rows must be contiguous in memory")
    return v


# The work split of csrc/scatter_update.cu (kUnitMax, kWarpRows, kWarps)
UNIT_MAX = 4096          # bytes of one copy unit
WARP_ROWS = 32           # rows a warp's units may span (an index a lane)
WARPS = 4                # warps of a CTA
CTAS_PER_SM = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """How one commit's row copies are cut into units and spread over the
    grid.  Unit u covers row ``u // per_row`` (= b * k + j) and, within it,
    unit ``q = u % per_row``: buffer t is the last with ``first[t] <= q``,
    bytes ``[(q - first[t]) * chunk[t], ... + chunk[t])`` of its row, cut
    at the row's end.  CTA c takes units ``[c * upc, (c + 1) * upc)``, its
    warp w the ``upw`` units from ``c * upc + w * upw`` that stay in the
    CTA's range, and no warp's units span more than WARP_ROWS rows."""
    chunk: Tuple[int, ...]
    first: Tuple[int, ...]
    per_row: int
    units: int
    upc: int
    upw: int
    grid: int


@functools.lru_cache(maxsize=1024)
def plan_units(row_bytes: Tuple[int, ...], rows: int, n_sm: int
               ) -> CopyPlan:
    """The work split of one commit of ``rows`` (= B * k) rows of buffers
    with these row widths, on a card of ``n_sm`` SMs: each row of a buffer
    is cut into the fewest units of at most UNIT_MAX bytes, of equal size
    rounded up to 16 bytes (so a unit keeps its row's alignment); at most
    CTAS_PER_SM CTAs an SM share the units in equal contiguous ranges
    (more where a warp's share would span more than WARP_ROWS rows)."""
    chunk, first, per_row = [], [], 0
    for rb in row_bytes:
        n_u = _cdiv(rb, UNIT_MAX)
        c = 16 * _cdiv(_cdiv(rb, n_u), 16) if n_u else 16
        chunk.append(c)
        first.append(per_row)
        per_row += _cdiv(rb, c)
    units = rows * per_row
    if units == 0:
        return CopyPlan(tuple(chunk), tuple(first), per_row, 0, 0, 0, 0)
    upc = min(_cdiv(units, min(units, CTAS_PER_SM * n_sm)),
              WARPS * ((WARP_ROWS - 1) * per_row + 1))
    return CopyPlan(tuple(chunk), tuple(first), per_row, units, upc,
                    _cdiv(upc, WARPS), _cdiv(units, upc))


def copy_width(*values: int) -> int:
    """The widest move (16, 4 or 1 bytes) that every address, stride and
    width in ``values`` allows."""
    g = 0
    for v in values:
        g = math.gcd(g, v)
    return next(w for w in (16, 4, 1) if g % w == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def scatter_update_multi(caches: Sequence[torch.Tensor], idx: torch.Tensor,
                         rows: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
    """One in-place multi-buffer commit (see module docstring)."""
    if idx.device.type == "cpu":
        return scatter_update_multi_plain(caches, idx, rows)
    _check_shapes(caches, idx, rows)
    _lib.require_cuda(idx, *caches, *rows)
    m = len(caches)
    if m > MAX_BUFFERS:
        raise ValueError(f"at most {MAX_BUFFERS} buffers per commit")
    b, k = idx.shape
    n = caches[0].shape[1]
    idx32 = idx.to(torch.int32).contiguous()
    srcs = [r.to(c.dtype).contiguous() for c, r in zip(caches, rows)]
    views = [_row_view(c) for c in caches]
    es = [v.element_size() for v in views]
    row_bytes = [v.shape[2] * e for v, e in zip(views, es)]
    dst_bs = [v.stride(0) * e for v, e in zip(views, es)]
    dst_rs = [v.stride(1) * e for v, e in zip(views, es)]
    plan = plan_units(tuple(row_bytes), b * k, _sm_count(idx.device.index))
    if plan.units == 0:
        return tuple(caches)
    vec = [copy_width(v.data_ptr(), s.data_ptr(), bs, rs, rb, c)
           for v, s, bs, rs, rb, c in zip(views, srcs, dst_bs, dst_rs,
                                          row_bytes, plan.chunk)]
    arr, iarr = ctypes.c_longlong * m, ctypes.c_int * m
    lib = _lib.load()
    _lib.check(lib.spa_scatter_update_multi(
        idx32.data_ptr(), b, k, n, m,
        arr(*[v.data_ptr() for v in views]),
        arr(*[s.data_ptr() for s in srcs]),
        arr(*row_bytes), arr(*dst_bs), arr(*dst_rs),
        arr(*[k * rb for rb in row_bytes]), arr(*row_bytes),
        iarr(*plan.chunk), iarr(*plan.first), iarr(*vec), plan.per_row,
        plan.upc, plan.upw, plan.grid, _lib.stream_ptr(idx)),
        "scatter_update_multi")
    _lib.LAUNCHES["scatter_update_multi"] += 1
    return tuple(caches)


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def gather_pages_plain(arena: torch.Tensor, pt: torch.Tensor
                       ) -> torch.Tensor:
    """arena [L, P, page, ...]; pt [B, n_log] -> [L, B, n_log*page, ...]."""
    l, page = arena.shape[0], arena.shape[2]
    b, n_log = pt.shape
    out = arena[:, pt.long()]                   # [L, B, n_log, page, ...]
    return out.reshape((l, b, n_log * page) + tuple(arena.shape[3:]))


def scatter_pages_plain(arena: torch.Tensor, pt: torch.Tensor,
                        dense: torch.Tensor) -> torch.Tensor:
    """Write dense [L, B, n_log*page, ...] back through pt, in place;
    pages with id 0 (the zero page) are skipped.  Returns arena."""
    l, page = arena.shape[0], arena.shape[2]
    b, n_log = pt.shape
    dense = dense.reshape((l, b, n_log, page) + tuple(arena.shape[3:]))
    ok = pt > 0
    arena[:, pt[ok].long()] = dense[:, ok].to(arena.dtype)
    return arena


def scatter_rows_paged_plain(arena: torch.Tensor, pt: torch.Tensor,
                             idx: torch.Tensor, rows: torch.Tensor
                             ) -> torch.Tensor:
    """arena [P, page, ...] (one layer); rows [B, k, ...] at idx [B, k],
    in place.  Returns arena."""
    page = arena.shape[1]
    n_log = pt.shape[1]
    ii = idx.long()
    lpage = torch.div(ii, page, rounding_mode="floor")
    pid = torch.gather(pt.long(), 1, lpage.clamp(0, n_log - 1))
    ok = (ii >= 0) & (lpage < n_log) & (pid > 0)
    arena[pid[ok], (ii % page)[ok]] = rows[ok].to(arena.dtype)
    return arena


def _page_bytes(arena: torch.Tensor) -> int:
    return math.prod(arena.shape[2:]) * arena.element_size()


def _check_pages(arena, pt, what):
    if arena.dim() < 3 or pt.dim() != 2:
        raise ValueError(f"{what}: arena [L, P, page, ...] and pt [B, n_log]"
                         f", got {tuple(arena.shape)}, {tuple(pt.shape)}")
    if not arena.is_contiguous():
        raise ValueError(f"{what}: the arena must be contiguous")


def gather_pages(arena: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """The dense view of a paged arena (see module docstring)."""
    if arena.device.type == "cpu":
        return gather_pages_plain(arena, pt)
    _lib.require_cuda(arena, pt)
    _check_pages(arena, pt, "gather_pages")
    l, p, page = arena.shape[:3]
    b, n_log = pt.shape
    out = torch.empty((l, b, n_log * page) + tuple(arena.shape[3:]),
                      dtype=arena.dtype, device=arena.device)
    pt32 = pt.to(torch.int32).contiguous()
    lib = _lib.load()
    _lib.check(lib.spa_gather_pages(
        arena.data_ptr(), pt32.data_ptr(), out.data_ptr(), l, p, b, n_log,
        _page_bytes(arena), _lib.stream_ptr(arena)), "gather_pages")
    _lib.LAUNCHES["gather_pages"] += 1
    return out


def scatter_pages(arena: torch.Tensor, pt: torch.Tensor,
                  dense: torch.Tensor) -> torch.Tensor:
    """Write a dense view back into the arena in place (see module
    docstring).  Returns arena."""
    if arena.device.type == "cpu":
        return scatter_pages_plain(arena, pt, dense)
    _lib.require_cuda(arena, pt, dense)
    _check_pages(arena, pt, "scatter_pages")
    l, p, page = arena.shape[:3]
    b, n_log = pt.shape
    if dense.numel() != l * b * n_log * math.prod(arena.shape[2:]):
        raise ValueError(f"scatter_pages: dense {tuple(dense.shape)} does not "
                         f"fill {b} rows of {n_log} pages of arena "
                         f"{tuple(arena.shape)}")
    dense = dense.to(arena.dtype).contiguous()
    pt32 = pt.to(torch.int32).contiguous()
    lib = _lib.load()
    _lib.check(lib.spa_scatter_pages(
        arena.data_ptr(), pt32.data_ptr(), dense.data_ptr(), l, p, b, n_log,
        _page_bytes(arena), _lib.stream_ptr(arena)), "scatter_pages")
    _lib.LAUNCHES["scatter_pages"] += 1
    return arena


def scatter_rows_paged(arena: torch.Tensor, pt: torch.Tensor,
                       idx: torch.Tensor, rows: torch.Tensor
                       ) -> torch.Tensor:
    """Row commits into one layer's arena in place (see module
    docstring).  ``arena`` may be a layer slice of [L, P, page, ...]: the
    kernel writes through its pointer and strides.  Returns arena."""
    if arena.device.type == "cpu":
        return scatter_rows_paged_plain(arena, pt, idx, rows)
    _lib.require_cuda(arena, pt, idx, rows)
    p, page = arena.shape[:2]
    b, k = idx.shape
    f = math.prod(arena.shape[2:])
    if pt.shape[0] != b or rows.shape[:2] != (b, k) \
            or rows.shape[2:] != arena.shape[2:]:
        raise ValueError(f"scatter_rows_paged: arena {tuple(arena.shape)}, "
                         f"pt {tuple(pt.shape)}, idx {tuple(idx.shape)}, "
                         f"rows {tuple(rows.shape)}")
    view = arena.reshape(p, page, f)
    if view.data_ptr() != arena.data_ptr() or view.stride(2) != 1:
        raise ValueError("scatter_rows_paged: arena rows must be contiguous")
    src = rows.to(arena.dtype).contiguous()
    pt32 = pt.to(torch.int32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    es = arena.element_size()
    lib = _lib.load()
    _lib.check(lib.spa_scatter_rows_paged(
        arena.data_ptr(), pt32.data_ptr(), idx32.data_ptr(), src.data_ptr(),
        b, k, pt.shape[1], page, f * es, view.stride(0) * es,
        view.stride(1) * es, _lib.stream_ptr(arena)), "scatter_rows_paged")
    _lib.LAUNCHES["scatter_rows_paged"] += 1
    return arena
