"""Caching strategies (the ``CacheStrategy`` protocol), as in the JAX package.

Every policy is a frozen dataclass implementing one protocol; the decode
surfaces accept a strategy at call time and ``ModelConfig.spa`` is only the
default spec.

  ``SPACache``        — the paper: rank-r singular proxy (§3.3) + piecewise-
                        Gaussian adaptive budget (Eq. 5); optionally the
                        incremental identifier (projection of the changed
                        rows only).
  ``ValueProxyCache`` — dLLM-Cache: full value-state proxy, uniform budget;
                        ``projection`` selects the Table-1 variants
                        (value / query / key / attn_in).
  ``WindowCache``     — dKV-Cache: rows near recently committed tokens
                        refresh (locality, no projection, no proxy cache).
  ``AttnOutCache``    — Table-1 'attn output' identifier: full attention
                        for identification, sparse FFN.
  ``NoCache``         — vanilla full recomputation (the baseline rows).

A strategy owns the identifier projection (``project`` /
``prefill_proxy``), the drift score (``score`` / ``pre_scores``), the
per-layer budget (``k_schedule`` / ``k_for``), the cache layout and commits
(``proxy_dim`` / ``commit_kv`` / ``commit``) and its offline artefacts
(``build_proxies``).  Its ``backend`` field selects the kernels of the hot
path (``CudaBackend`` by default: the CUDA kernels on the card, their plain
versions on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, List, Optional, Type

import torch

from repro_torch.configs.base import ATTENTION_KINDS, ModelConfig, SPAConfig
from repro_torch.kernels.backend import CUDA_BACKEND, KernelBackend

Params = Dict[str, Any]

REGISTRY: Dict[str, Type["CacheStrategy"]] = {}


def register(*idents: str):
    def deco(cls):
        for ident in idents:
            REGISTRY[ident] = cls
        return cls

    return deco


@dataclasses.dataclass(frozen=True)
class CacheStrategy:
    """Protocol base.  Subclasses override the class-vars and methods."""

    refresh_interval: int = 0
    n_buckets: int = 6
    backend: KernelBackend = CUDA_BACKEND

    name: ClassVar[str] = "abstract"
    uses_cache: ClassVar[bool] = True     # False only for NoCache
    uses_proxy_mat: ClassVar[bool] = False   # True only for SPACache
    full_attn_ident: ClassVar[bool] = False  # True only for AttnOutCache
    incremental: ClassVar[bool] = False      # proxy recompute on changed rows

    @property
    def spec(self) -> SPAConfig:
        raise NotImplementedError

    def with_backend(self, backend) -> "CacheStrategy":
        """Same strategy, hot path on the given backend (or its name)."""
        from repro_torch.kernels.backend import resolve_backend
        return dataclasses.replace(self, backend=resolve_backend(backend))

    def prefix_key(self) -> Any:
        """Hashable identity of this strategy's PREFILL states, part of the
        shared-prefix index's root key: two strategies with the same key
        build identical prefill caches, so their requests may share
        published pages.  Unlike the JAX package, the prefill here runs
        its attention on the backend, so the backend's name is part of
        the key (the two backends' pages may differ in their low bits)."""
        return self.spec, self.backend.name

    # ---- budget ----

    def k_schedule(self, cfg: ModelConfig, seq_len: int) -> List[int]:
        """Static per-layer update counts k(l)."""
        from repro_torch.core import budget
        return budget.k_schedule(self.spec, cfg.n_layers, seq_len)

    def k_for(self, cfg: ModelConfig, layer: int, seq_len: int) -> int:
        return self.k_schedule(cfg, seq_len)[layer]

    # ---- identification ----

    def project(self, h: torch.Tensor, bp: Params,
                proxy_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError(f"{self.name} has no projection")

    def projection_matrix(self, bp: Params,
                          proxy_mat: Optional[torch.Tensor] = None
                          ) -> Optional[torch.Tensor]:
        """The [d, r] matrix M with ``project(h) == h @ M``, or None."""
        return None

    def score(self, p_now: torch.Tensor,
              p_cached: torch.Tensor) -> torch.Tensor:
        """Similarity per row [B, N]; LOW = drifted = update."""
        from repro_torch.core.identifiers import drift_scores
        return drift_scores(p_now, p_cached)

    def pre_scores(self, n: int, committed: torch.Tensor
                   ) -> Optional[torch.Tensor]:
        """Scores computed BEFORE the layer stack from decode-loop state
        (the committed-token ring); None for projection-based strategies."""
        return None

    def prefill_proxy(self, bp: Params, proxy_mat, h_in, x, attn_out,
                      h_out) -> Optional[torch.Tensor]:
        """Identifier vectors collected during prefill: the projection of
        h * (1 + norm1) WITHOUT the rms division, exactly the serve path's
        identifier input, so unchanged rows tie at cosine 1.0."""
        scaled = h_in * (1.0 + bp["norm1"]).to(h_in.dtype)
        return self.project(scaled, bp, proxy_mat)

    # ---- cache layout + lifecycle ----

    def proxy_dim(self, cfg: ModelConfig) -> int:
        return 0

    def commit_kv(self, cache_sl: Dict[str, torch.Tensor], idx, k_rows,
                  v_rows, policy) -> Dict[str, torch.Tensor]:
        """Scatter refreshed K/V rows into the layer cache at idx (one
        multi-buffer kernel launch on ``CudaBackend``)."""
        from repro_torch.core import cache as cache_lib
        return cache_lib.write_kv(cache_sl, idx, k_rows, v_rows, policy,
                                  backend=self.backend)

    def commit(self, cache_sl: Dict[str, torch.Tensor], idx, h_rows,
               policy, *, p_now: Optional[torch.Tensor] = None,
               proxy_now: Optional[torch.Tensor] = None,
               attn_all: Optional[torch.Tensor] = None,
               page_table: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Scatter refreshed block outputs (+ int8 scale) and the selected
        identifier rows at idx in ONE multi-buffer commit.  With
        ``page_table`` the ``proxy`` buffer is a page arena: its rows
        commit through the page table (``backend.scatter_rows_paged``) and
        the dense view's buffers keep the multi-buffer commit.

        The incremental identifier passes ``proxy_now`` (every row's
        current identifier, the ``proxy_now`` buffer already updated in
        place); the non-incremental one passes ``p_now``, which also
        becomes ``proxy_now`` where the cache keeps one."""
        from repro_torch.core import cache as cache_lib
        from repro_torch.core import selection
        upd = cache_lib.h_row_update(h_rows, policy)
        src = proxy_now if proxy_now is not None else p_now
        if src is not None and "proxy" in cache_sl:
            proxy_rows = selection.gather_rows(src, idx)
            if page_table is not None:
                self.backend.scatter_rows_paged(cache_sl["proxy"],
                                                page_table, idx, proxy_rows)
            else:
                upd["proxy"] = proxy_rows
        cache_lib.scatter_buffers(cache_sl, idx, upd, backend=self.backend)
        if (src is not None and "proxy_now" in cache_sl
                and src is not cache_sl["proxy_now"]):
            cache_sl["proxy_now"].copy_(src)
        return cache_sl

    def refresh_cache(self, params: Params, cfg: ModelConfig,
                      tokens: torch.Tensor, spa_proxies=None,
                      kv_len: Optional[torch.Tensor] = None,
                      extras: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Full cache rebuild from the current canvas (a prefill);
        ``extras`` are the canvas's modality stubs (a VLM's patches)."""
        if not self.uses_cache:
            return {}
        from repro_torch.dlm import decoding
        inputs = dict(extras) if extras else {}
        inputs["tokens"] = tokens
        _, cache = decoding.prefill(params, cfg, inputs, spa_proxies, self,
                                    kv_len=kv_len)
        return cache

    # ---- offline artefacts ----

    def build_proxies(self, params: Params, cfg: ModelConfig
                      ) -> Optional[Dict[str, torch.Tensor]]:
        return None

    def proxy_specs(self, cfg: ModelConfig
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """Meta tensors of the proxy stacks' shapes and dtype (the dry
        run's abstract proxies); None for strategies without proxies."""
        return None


@register("singular")
@dataclasses.dataclass(frozen=True)
class SPACache(CacheStrategy):
    """The paper: rank-r singular proxy + adaptive budget (Alg. 1)."""

    rank: int = 128
    schedule: str = "adaptive"
    rho_peak: float = 0.25
    rho_first: float = 0.03
    rho_last: float = 0.13
    layer_peak: Optional[int] = None
    incremental_ident: bool = False   # beyond-paper: changed rows only

    name: ClassVar[str] = "spa"
    uses_proxy_mat: ClassVar[bool] = True

    @property
    def incremental(self) -> bool:  # type: ignore[override]
        return self.incremental_ident

    @property
    def spec(self) -> SPAConfig:
        return SPAConfig(
            identifier="singular", rank=self.rank, schedule=self.schedule,
            rho_peak=self.rho_peak, rho_first=self.rho_first,
            rho_last=self.rho_last, layer_peak=self.layer_peak,
            n_buckets=self.n_buckets,
            refresh_interval=self.refresh_interval,
            incremental_ident=self.incremental_ident)

    @classmethod
    def from_spec(cls, spa: SPAConfig) -> "SPACache":
        return cls(rank=spa.rank, schedule=spa.schedule,
                   rho_peak=spa.rho_peak, rho_first=spa.rho_first,
                   rho_last=spa.rho_last, layer_peak=spa.layer_peak,
                   n_buckets=spa.n_buckets,
                   refresh_interval=spa.refresh_interval,
                   incremental_ident=spa.incremental_ident)

    def proxy_dim(self, cfg: ModelConfig) -> int:
        return self.rank

    def project(self, h, bp, proxy_mat=None):
        assert proxy_mat is not None, "SPACache needs offline proxies"
        return h @ proxy_mat

    def projection_matrix(self, bp, proxy_mat=None):
        assert proxy_mat is not None, "SPACache needs offline proxies"
        return proxy_mat

    def build_proxies(self, params, cfg):
        """Offline SVD of value projections -> {kind: [Lk, d, r]}."""
        from repro_torch.core.svd_proxy import build_proxy_stack
        return {kind: build_proxy_stack(params["blocks"][kind]["wv"],
                                        self.rank)
                for kind in sorted(set(cfg.layer_kinds))
                if kind in ATTENTION_KINDS}

    def proxy_specs(self, cfg):
        from repro_torch.device import torch_dtype
        return {kind: torch.empty(
                    (cfg.n_layers_of_kind(kind), cfg.d_model, self.rank),
                    dtype=torch_dtype(cfg.param_dtype), device="meta")
                for kind in sorted(set(cfg.layer_kinds))
                if kind in ATTENTION_KINDS}


@dataclasses.dataclass(frozen=True)
class _RhoBudgetStrategy(CacheStrategy):
    """Shared budget fields of the baseline strategies.

    ``rho_first``/``rho_last``/``layer_peak`` only matter with
    ``schedule="adaptive"``; None means flat at ``rho``."""

    schedule: str = "uniform"
    rho: float = 0.25
    rho_first: Optional[float] = None
    rho_last: Optional[float] = None
    layer_peak: Optional[int] = None

    def _spec_budget(self) -> Dict[str, Any]:
        return dict(
            schedule=self.schedule, rho_peak=self.rho,
            rho_first=self.rho if self.rho_first is None else self.rho_first,
            rho_last=self.rho if self.rho_last is None else self.rho_last,
            layer_peak=self.layer_peak, n_buckets=self.n_buckets,
            refresh_interval=self.refresh_interval)

    @staticmethod
    def _budget_from_spec(spa: SPAConfig) -> Dict[str, Any]:
        def ramp(r):                 # flat-at-rho normalizes to None
            return None if r == spa.rho_peak else r
        return dict(schedule=spa.schedule, rho=spa.rho_peak,
                    rho_first=ramp(spa.rho_first),
                    rho_last=ramp(spa.rho_last), layer_peak=spa.layer_peak,
                    n_buckets=spa.n_buckets,
                    refresh_interval=spa.refresh_interval)


@register("value", "query", "key", "attn_in")
@dataclasses.dataclass(frozen=True)
class ValueProxyCache(_RhoBudgetStrategy):
    """dLLM-Cache (value) and the Table-1 projection ablations."""

    projection: str = "value"        # value | query | key | attn_in
    incremental_ident: bool = False  # changed-rows-only projection

    name: ClassVar[str] = "value_proxy"

    @property
    def incremental(self) -> bool:  # type: ignore[override]
        return self.incremental_ident

    @property
    def spec(self) -> SPAConfig:
        return SPAConfig(identifier=self.projection,
                         incremental_ident=self.incremental_ident,
                         **self._spec_budget())

    @classmethod
    def from_spec(cls, spa: SPAConfig) -> "ValueProxyCache":
        return cls(projection=spa.identifier,
                   incremental_ident=spa.incremental_ident,
                   **cls._budget_from_spec(spa))

    def proxy_dim(self, cfg: ModelConfig) -> int:
        return {"value": cfg.kv_dim, "key": cfg.kv_dim,
                "query": cfg.q_dim, "attn_in": cfg.d_model}[self.projection]

    def project(self, h, bp, proxy_mat=None):
        w = self.projection_matrix(bp, proxy_mat)
        return h if w is None else h @ w    # attn_in: the raw inputs

    def projection_matrix(self, bp, proxy_mat=None):
        w = {"value": "wv", "query": "wq", "key": "wk"}.get(self.projection)
        return bp[w] if w else None   # attn_in: identity (score-only)


@register("window")
@dataclasses.dataclass(frozen=True)
class WindowCache(_RhoBudgetStrategy):
    """dKV-Cache-style locality heuristic: rows within ``locality_window``
    of a recently committed token refresh; no projection, no proxy cache."""

    locality_window: int = 64

    name: ClassVar[str] = "window"

    @property
    def spec(self) -> SPAConfig:
        return SPAConfig(identifier="window",
                         locality_window=self.locality_window,
                         **self._spec_budget())

    @classmethod
    def from_spec(cls, spa: SPAConfig) -> "WindowCache":
        return cls(locality_window=spa.locality_window,
                   **cls._budget_from_spec(spa))

    def pre_scores(self, n: int, committed: torch.Tensor):
        from repro_torch.core.identifiers import locality_scores
        return locality_scores(n, committed, self.locality_window)

    def prefill_proxy(self, bp, proxy_mat, h_in, x, attn_out, h_out):
        return None


@register("attn_out")
@dataclasses.dataclass(frozen=True)
class AttnOutCache(_RhoBudgetStrategy):
    """Table-1 'attn output' identifier: full attention against the stale
    cached K/V for ALL rows (identification only), sparse FFN after."""

    name: ClassVar[str] = "attn_out"
    full_attn_ident: ClassVar[bool] = True

    @property
    def spec(self) -> SPAConfig:
        return SPAConfig(identifier="attn_out", **self._spec_budget())

    @classmethod
    def from_spec(cls, spa: SPAConfig) -> "AttnOutCache":
        return cls(**cls._budget_from_spec(spa))

    def proxy_dim(self, cfg: ModelConfig) -> int:
        return cfg.d_model

    def prefill_proxy(self, bp, proxy_mat, h_in, x, attn_out, h_out):
        return attn_out

    def commit(self, cache_sl, idx, h_rows, policy, *, p_now=None,
               proxy_now=None, attn_all=None, page_table=None):
        from repro_torch.core import cache as cache_lib
        cache_lib.write_h(cache_sl, idx, h_rows, policy,
                          backend=self.backend)
        # momentum signal: proxy = this step's full attention output (paged:
        # a whole-view page write; zero-page tails drop)
        if page_table is not None:
            self.backend.scatter_pages(cache_sl["proxy"][None], page_table,
                                       attn_all[None])
        else:
            cache_sl["proxy"].copy_(attn_all)
        return cache_sl


@register("none")
@dataclasses.dataclass(frozen=True)
class NoCache(CacheStrategy):
    """Vanilla full recomputation every refinement step (baseline)."""

    name: ClassVar[str] = "none"
    uses_cache: ClassVar[bool] = False

    @property
    def spec(self) -> SPAConfig:
        return SPAConfig(identifier="none")

    @classmethod
    def from_spec(cls, spa: SPAConfig) -> "NoCache":
        return cls()

    def k_schedule(self, cfg: ModelConfig, seq_len: int) -> List[int]:
        return [seq_len] * cfg.n_layers

    def prefill_proxy(self, bp, proxy_mat, h_in, x, attn_out, h_out):
        return None


def strategy_from_spec(spa: SPAConfig) -> CacheStrategy:
    """Build the strategy described by a (serializable) ``SPAConfig``."""
    cls = REGISTRY.get(spa.identifier)
    if cls is None:
        raise ValueError(
            f"unknown identifier {spa.identifier!r}; registered: "
            f"{sorted(REGISTRY)}")
    return cls.from_spec(spa)



def resolve_strategy(cfg: ModelConfig,
                     strategy: Optional[CacheStrategy] = None
                     ) -> CacheStrategy:
    """Call-time strategy wins; ``cfg.spa`` is only the default spec."""
    return strategy if strategy is not None else strategy_from_spec(cfg.spa)
