"""KernelBackend — the hot-path stages of ``repro/kernels/backend.py``.

A SPA layer step has four kernel-shaped stages on the dense path
(identification, the gather + norm epilogue, gathered-query attention and
the cache commits) plus a score-only pass and three paged stages; the
Mamba-2 mixer adds a ninth, the SSD chunked scan (``ssd_scan``), and the
RG-LRU mixer a tenth, its linear recurrence (``rglru_scan``; port-only:
the JAX model runs an associative scan there).  A backend owns all of them
and rides on the ``CacheStrategy`` (a frozen dataclass field), exactly as
in the JAX package.

  ``TorchBackend`` — the plain PyTorch versions, on any device: the oracle.
  ``CudaBackend``  — the kernel wrappers: CUDA kernels for tensors on the
                     card, the plain versions for tensors on the CPU.  It
                     has no fallback: a kernel that cannot build or launch
                     raises.

Dispatch rules follow the JAX package's ``PallasBackend``: selection
(top-k) stays plain tensor code, and the identification kernels engage
only when the strategy keeps the base cosine ``score``.  Then a plain
matrix projection goes to ``proxy_score`` (any rank), the identity
projection (attn_in) to the score-only ``cosine_drift``, and any other
projection runs the strategy's own ops.  With a page table (paged
serving) the cached identifiers are a pooled page arena [P, page, r]: the
same three routes become ``proxy_score_paged``, ``cosine_drift_paged`` and
a dense gather of the pages.  ``score_drift`` (the incremental rescore,
the attn_out momentum) is ``cosine_drift`` / ``cosine_drift_paged``.  A
strategy that overrides ``score`` runs its own ops on every route.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional

import torch

from repro_torch.kernels import proxy_score as ps
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import scatter_update as sc
from repro_torch.kernels import sparse_attention as sa
from repro_torch.kernels import ssd_chunk
from repro_torch.models.attention import attention_hints

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Protocol base: the hot-path stages of one SPA layer step."""

    name: ClassVar[str] = "abstract"

    def identifier_scores(self, strategy, bp: Params, proxy_mat,
                          x: torch.Tensor, p_cached: torch.Tensor,
                          page_table=None):
        """Phase 1: project x and score drift. Returns (scores, p_now).
        With ``page_table`` [B, n_log], ``p_cached`` is one layer's page
        arena [P, page, r] instead of a dense [B, N, r] buffer."""
        raise NotImplementedError

    def score_drift(self, strategy, p_now, p_cached, page_table=None):
        """Score-only drift (incremental rescore, attn_out momentum);
        ``page_table`` as in :meth:`identifier_scores`."""
        raise NotImplementedError

    def gather_norm(self, h, idx, weight, eps):
        """Phase-1 epilogue: returns (rows [B,k,d], rms-normed rows)."""
        raise NotImplementedError

    def attention(self, q, k, v, *, k_scale=None, v_scale=None,
                  q_positions=None, window: int = 0, soft_cap: float = 0.0,
                  banded: bool = False, q_span: int = 0, kv_len=None):
        """Phase 2: (gathered-)query attention vs the KV cache; the banded
        grid where ``banded`` and ``q_span`` make it engage (``q_positions``
        None: a contiguous canvas, whose q blocks span ``min(512, Sq)``)."""
        raise NotImplementedError

    def scatter_multi(self, buffers: Dict[str, torch.Tensor], idx,
                      rows: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Phase 2/3 commit: scatter row payloads into cache buffers (in
        place; returns the same buffers)."""
        raise NotImplementedError

    def gather_pages(self, arena, page_table):
        """arena [L, P, page, ...] + page table [B, n_log] -> dense view
        [L, B, n_log*page, ...]."""
        raise NotImplementedError

    def scatter_pages(self, arena, page_table, dense):
        """Write a dense view back through the page table, into the arena
        in place (writes to the zero page drop).  Returns the arena."""
        raise NotImplementedError

    def scatter_rows_paged(self, arena, page_table, idx, rows):
        """Commit rows [B, k, ...] at logical rows idx [B, k] into ONE
        layer's arena [P, page, ...] in place (zero-page and out-of-range
        rows drop).  Returns the arena."""
        raise NotImplementedError

    def ssd_scan(self, x, dt, la, b, c, chunk: int):
        """The SSD chunked scan: x [B, T, H, hd], dt and la [B, T, H] f32
        (la the in-chunk cumulative sum of dt * a), b, c [B, T, ds] ->
        y [B, T, H, hd] in x's dtype."""
        raise NotImplementedError

    def rglru_scan(self, a, x):
        """The RG-LRU recurrence h_t = a_t * h_{t-1} + x_t: a, x [B, T, d]
        of one dtype -> h [B, T, d] in a's dtype (f32 carry)."""
        raise NotImplementedError

    @staticmethod
    def _base_score(strategy) -> bool:
        """Whether the strategy keeps the protocol's cosine ``score``."""
        from repro_torch.core.strategy import CacheStrategy
        return type(strategy).score is CacheStrategy.score


@dataclasses.dataclass(frozen=True)
class TorchBackend(KernelBackend):
    """The plain PyTorch versions of every kernel (the oracle)."""

    name: ClassVar[str] = "torch"

    def identifier_scores(self, strategy, bp, proxy_mat, x, p_cached,
                          page_table=None):
        if page_table is not None:
            p_cached = self.gather_pages(p_cached[None], page_table)[0]
        mat = (strategy.projection_matrix(bp, proxy_mat)
               if self._base_score(strategy) else None)
        if mat is None:
            p_now = strategy.project(x, bp, proxy_mat)
            return strategy.score(p_now, p_cached), p_now
        return ps.proxy_score_plain(x, mat, p_cached)

    def score_drift(self, strategy, p_now, p_cached, page_table=None):
        if page_table is not None:
            p_cached = self.gather_pages(p_cached[None], page_table)[0]
        return strategy.score(p_now, p_cached)

    def gather_norm(self, h, idx, weight, eps):
        return ps.gather_norm_plain(h, idx, weight, eps)

    def attention(self, q, k, v, *, k_scale=None, v_scale=None,
                  q_positions=None, window=0, soft_cap=0.0, banded=False,
                  q_span=0, kv_len=None):
        q, k, v, k_scale, v_scale = attention_hints(q, k, v, k_scale,
                                                    v_scale)
        q_positions, q_span = _positions(q, q_positions, q_span)
        band = sa.band_for(q_positions, k.shape[1], window, q_span,
                           banded=banded)
        return sa.sparse_attention_plain(
            q, k, v, q_positions, k_scale=k_scale, v_scale=v_scale,
            window=window, soft_cap=soft_cap, kv_len=kv_len, band=band)

    def scatter_multi(self, buffers, idx, rows):
        names = sorted(rows)
        sc.scatter_update_multi_plain([buffers[n] for n in names], idx,
                                      [rows[n] for n in names])
        return {n: buffers[n] for n in names}

    def gather_pages(self, arena, page_table):
        return sc.gather_pages_plain(arena, page_table)

    def scatter_pages(self, arena, page_table, dense):
        return sc.scatter_pages_plain(arena, page_table, dense)

    def scatter_rows_paged(self, arena, page_table, idx, rows):
        return sc.scatter_rows_paged_plain(arena, page_table, idx, rows)

    def ssd_scan(self, x, dt, la, b, c, chunk):
        return ssd_chunk.ssd_chunk_scan_plain(x, dt, la, b, c, chunk)

    def rglru_scan(self, a, x):
        return rs.rglru_scan_plain(a, x)


@dataclasses.dataclass(frozen=True)
class CudaBackend(KernelBackend):
    """The hand-written Hopper kernels (``csrc/``) on the hot path."""

    name: ClassVar[str] = "cuda"

    def identifier_scores(self, strategy, bp, proxy_mat, x, p_cached,
                          page_table=None):
        if not self._base_score(strategy):
            return TORCH_BACKEND.identifier_scores(
                strategy, bp, proxy_mat, x, p_cached, page_table=page_table)
        mat = strategy.projection_matrix(bp, proxy_mat)
        if page_table is not None:
            if mat is not None:
                return ps.proxy_score_paged(x, mat, p_cached, page_table)
            p_now = strategy.project(x, bp, proxy_mat)
            if p_now is x:  # identity projection: paged score-only
                return ps.cosine_drift_paged(x, p_cached, page_table), p_now
            p_dense = self.gather_pages(p_cached[None], page_table)[0]
            return strategy.score(p_now, p_dense), p_now
        if mat is not None:
            return ps.proxy_score(x, mat, p_cached)
        p_now = strategy.project(x, bp, proxy_mat)
        if p_now is x:      # identity projection (attn_in): score-only
            return ps.cosine_drift(x, p_cached), p_now
        # a projection that is no plain matrix: the strategy's own ops
        return strategy.score(p_now, p_cached), p_now

    def score_drift(self, strategy, p_now, p_cached, page_table=None):
        if not self._base_score(strategy):
            if page_table is not None:
                p_cached = self.gather_pages(p_cached[None], page_table)[0]
            return strategy.score(p_now, p_cached)
        if page_table is not None:
            return ps.cosine_drift_paged(p_now, p_cached, page_table)
        return ps.cosine_drift(p_now, p_cached)

    def gather_norm(self, h, idx, weight, eps):
        return ps.gather_norm(h, idx, weight, eps)

    def attention(self, q, k, v, *, k_scale=None, v_scale=None,
                  q_positions=None, window=0, soft_cap=0.0, banded=False,
                  q_span=0, kv_len=None):
        q_positions, q_span = _positions(q, q_positions, q_span)
        return sa.sparse_attention(
            q, k, v, q_positions, k_scale=k_scale, v_scale=v_scale,
            window=window, soft_cap=soft_cap, banded=banded, q_span=q_span,
            kv_len=kv_len)

    def scatter_multi(self, buffers, idx, rows):
        names = sorted(rows)
        sc.scatter_update_multi([buffers[n] for n in names], idx,
                                [rows[n] for n in names])
        return {n: buffers[n] for n in names}

    def gather_pages(self, arena, page_table):
        return sc.gather_pages(arena, page_table)

    def scatter_pages(self, arena, page_table, dense):
        return sc.scatter_pages(arena, page_table, dense)

    def scatter_rows_paged(self, arena, page_table, idx, rows):
        return sc.scatter_rows_paged(arena, page_table, idx, rows)

    def ssd_scan(self, x, dt, la, b, c, chunk):
        return ssd_chunk.ssd_chunk_scan(x, dt, la, b, c, chunk)

    def rglru_scan(self, a, x):
        return rs.rglru_scan(a, x)


def _positions(q, q_positions, q_span):
    """Contiguous canvas (prefill): positions arange, span one q block."""
    if q_positions is not None:
        return q_positions, q_span
    b, sq = q.shape[:2]
    pos = torch.arange(sq, device=q.device, dtype=torch.int32)
    return pos.expand(b, sq), min(sa.BLOCK_Q, sq)


TORCH_BACKEND = TorchBackend()
CUDA_BACKEND = CudaBackend()

REGISTRY: Dict[str, KernelBackend] = {
    "torch": TORCH_BACKEND,
    "cuda": CUDA_BACKEND,
}


def resolve_backend(backend) -> KernelBackend:
    """Accept a KernelBackend instance or a registry name."""
    if isinstance(backend, str):
        try:
            return REGISTRY[backend]
        except KeyError:
            raise ValueError(f"unknown kernel backend {backend!r}; "
                             f"registered: {sorted(REGISTRY)}") from None
    return backend
