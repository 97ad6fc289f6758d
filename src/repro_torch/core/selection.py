"""Top-k update selection and batched gather/scatter (Algorithm 2, Phase 1).

``select_topk_drift`` is the paper's global top-k; ``select_stratified``
the per-sequence-block top-(k/nb) of windowed layers on a long canvas.

``select_topk_drift`` keeps the JAX package's semantics exactly: scores
are quantized by ``_SCORE_QUANTUM`` and, among equal quantized scores, the
LOWEST index wins (``jax.lax.top_k``'s order).  ``torch.topk`` promises no
tie order, so selection is a stable ascending sort of the quantized key.
"""
from __future__ import annotations

import torch

# Similarity quantum for tie-breaking (see the JAX package's selection.py):
# cross-program float noise on unchanged rows is ~1e-7, real drift is
# >> 2^-12, so quantized scores make ties index-stable.
_SCORE_QUANTUM = 4096.0


def _stable(scores: torch.Tensor) -> torch.Tensor:
    return torch.round(scores.float() * _SCORE_QUANTUM)


def topk_lowest_first(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k LARGEST entries along the last axis, ties broken
    lowest index first (``jax.lax.top_k`` order), largest first."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def select_topk_drift(scores: torch.Tensor, k: int, *,
                      sort_positions: bool = True) -> torch.Tensor:
    """scores: [B, N] similarity (LOW = drifted = update). Returns [B, k]
    int32 positions."""
    n = scores.shape[-1]
    k = min(k, n)
    idx = topk_lowest_first(-_stable(scores), k)
    if sort_positions:
        idx = torch.sort(idx, dim=-1).values
    return idx.to(torch.int32)


def select_stratified(scores: torch.Tensor, k: int,
                      n_blocks: int) -> torch.Tensor:
    """Per-block top-(k / n_blocks) over n_blocks equal sequence blocks
    (the long-context windowed selection, so a q block of the gathered
    rows spans a bounded range of positions).  Same quantum and ties as
    ``select_topk_drift``.  Returns globally sorted [B, k'] int32 with
    k' = (k // n_blocks) * n_blocks (at least n_blocks)."""
    b, n = scores.shape
    n_blocks = max(1, min(n_blocks, n))
    while n % n_blocks:
        n_blocks -= 1
    per = max(1, k // n_blocks)
    size = n // n_blocks
    blocked = _stable(scores).reshape(b, n_blocks, size)
    idx = topk_lowest_first(-blocked, min(per, size))
    offset = (torch.arange(n_blocks, device=scores.device)
              * size)[None, :, None]
    idx = (idx + offset).reshape(b, -1)
    return torch.sort(idx, dim=-1).values.to(torch.int32)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, N, ...]; idx: [B, k] -> [B, k, ...].  Out-of-range indices
    clamp into [0, N) (a "clip"-mode gather)."""
    ii = idx.long().clamp(0, x.shape[1] - 1)
    bb = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bb, ii]


def scatter_rows(x: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write rows [B, k, ...] into x [B, N, ...] at idx [B, k], IN PLACE;
    indices >= N (the sentinel N padding) or < -N are dropped.  Returns x.

    Like the JAX package's ``.at[idx].set(mode="drop")``, an index in
    [-N, 0) counts from the end.  (The scatter kernels of both packages
    drop every index outside [0, N) instead; no caller passes negatives.)"""
    n = x.shape[1]
    ii = idx.long()
    ok = (ii >= -n) & (ii < n)
    ii = torch.where(ii < 0, ii + n, ii)
    bb = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(ii)
    x[bb[ok], ii[ok]] = rows[ok].to(x.dtype)
    return x
