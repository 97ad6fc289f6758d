"""Phase-2/3 kernel: commit row payloads into several cache buffers.

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
"""
from __future__ import annotations

from typing import Sequence, Tuple

import ctypes

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
    row_bytes = [v.shape[2] * v.element_size() for v in views]
    arr = ctypes.c_longlong * m
    lib = _lib.load()
    _lib.check(lib.spa_scatter_update_multi(
        idx32.data_ptr(), b, k, n, m,
        arr(*[v.data_ptr() for v in views]),
        arr(*[s.data_ptr() for s in srcs]),
        arr(*row_bytes),
        arr(*[v.stride(0) * v.element_size() for v in views]),
        arr(*[v.stride(1) * v.element_size() for v in views]),
        arr(*[k * rb for rb in row_bytes]),
        arr(*row_bytes),
        _lib.stream_ptr(idx)), "scatter_update_multi")
    _lib.LAUNCHES["scatter_update_multi"] += 1
    return tuple(caches)
