"""SPA-Cache transformer block (paper Algorithm 1) + layer orchestration.

Phase 1 — identification & selection: project the current inputs to
identifier vectors, score cosine drift against the cached identifiers and
select the top-k most-drifted rows.
Phase 2 — attention with a partially cached KV: recompute Q/K/V for the
selected rows only, commit K/V to the cache, then attend the selected
queries to the whole (partially refreshed) cache.
Phase 3 — FFN & output update on the selected rows, committed into H^c;
the layer output is the whole refreshed H^c.

The kernel-shaped stages (identification, gather + norm, attention, the
two commits) dispatch through ``strategy.backend``.  Caches are updated in
place.  Paged serving: with ``page_table`` the ``proxy`` buffer of a layer
is its page arena [P, page, r] (identification and the proxy commit go
through the page table), and ``kv_len`` [B] marks each row's valid canvas
length: rows past it never select and are never attended.

Windowed layers on a canvas longer than 8192 select per stratum
(``select_stratified``), so the gathered queries of a q block span at most
``q_span_bound`` positions and attention runs the banded grid where that
bound makes it engage; the selection then holds ``k_eff`` = (k // nb) * nb
rows.  Hybrid stacks run their recurrent blocks densely
(``apply_block_dense``).

Identification variants, as in the JAX package: ``scores_override``
(the window strategy's locality scores, computed before the layer stack)
replaces identification; the incremental identifier re-projects only the
rows whose inputs changed (the previous layer's selection, the step's
newly committed tokens at layer 0; after a recurrent block every row, so
the next attention layer identifies in full) into ``proxy_now`` and
rescores every row with the backend's score-only pass; ``AttnOutCache``
runs full attention for identification and a sparse FFN.

k per layer: the JAX package runs homogeneous all-attention models of
8 layers or more as a layer scan whose segments share the bucketed k of
``budget.bucketize`` -- but only without a score override -- and every
other case with the exact ``k_schedule``.  The port has no scan but uses
the same k for every layer in every case (``layer_ks``), so the two
packages select the same rows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ATTENTION_KINDS, ModelConfig
from repro_torch.core import budget, cache as cache_lib, selection
from repro_torch.core.cache import CachePolicy
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.models import common
from repro_torch.models.transformer import (apply_block_dense,
                                            apply_ffn_or_moe, layer_params,
                                            layer_window, qkv_project)

Params = Dict[str, Any]


def stratify_blocks_for(n: int, k: int) -> int:
    """Number of strata so that every q block's position span is bounded
    (windowed layers, n > 8192): each stratum is about 4096 positions."""
    if n <= 8192:
        return 0
    nb = max(1, n // 4096)
    while n % nb:
        nb -= 1
    return nb


def q_span_bound(n: int, k: int, nb: int, block_q: int = 512) -> int:
    """With per-stratum top-(k/nb) selection, any ``block_q`` consecutive
    selected rows span at most this many positions (0: no bound)."""
    if nb <= 1:
        return 0
    per = max(1, k // nb)
    stratum = n // nb
    n_strata_per_block = (block_q + per - 1) // per + 1
    return n_strata_per_block * stratum


def _mask_tail_scores(scores: torch.Tensor, n: int,
                      kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows past a request's valid canvas length never select (their
    similarity is forced to +inf: LOW = drifted = update)."""
    if kv_len is None:
        return scores
    pos = torch.arange(n, device=scores.device)[None, :]
    return torch.where(pos < kv_len.long()[:, None], scores, torch.inf)


def _identifier_scores(strategy: CacheStrategy, bp: Params, proxy_mat, x,
                       cache_sl, scores_override=None, prev_idx=None,
                       page_table=None):
    """Returns (scores [B, N] f32, p_now or None, proxy_now or None).

    Incremental mode: only rows whose INPUTS changed (``prev_idx`` [B,
    k_max], sentinel N for padding) can have drifted identifiers, so the
    projection runs on those rows alone and writes them into the
    ``proxy_now`` buffer (in place); every row is then rescored against
    the cached identifiers by the backend's score-only pass."""
    backend = strategy.backend
    if scores_override is not None:
        return scores_override, None, None
    if (strategy.incremental and prev_idx is not None
            and "proxy_now" in cache_sl):
        rows = selection.gather_rows(x, prev_idx)    # x = scaled h
        p_rows = strategy.project(rows, bp, proxy_mat)
        # the sentinel rows drop; the multi-buffer commit drops every
        # index outside [0, N), which is the JAX scatter's rule for the
        # indices given here (top-k positions and the sentinel)
        proxy_now = backend.scatter_multi(
            {"proxy_now": cache_sl["proxy_now"]}, prev_idx,
            {"proxy_now": p_rows})["proxy_now"]
        scores = backend.score_drift(strategy, proxy_now.float(),
                                     cache_sl["proxy"],
                                     page_table=page_table)
        return scores, None, proxy_now
    scores, p_now = backend.identifier_scores(strategy, bp, proxy_mat, x,
                                              cache_sl["proxy"],
                                              page_table=page_table)
    return scores, p_now, None


def spa_attn_block(cfg: ModelConfig, kind: str, bp: Params,
                   proxy_mat: Optional[torch.Tensor],
                   cache_sl: Dict[str, torch.Tensor], h: torch.Tensor,
                   k_upd: int, policy: CachePolicy,
                   strategy: Optional[CacheStrategy] = None,
                   scores_override: Optional[torch.Tensor] = None,
                   prev_idx: Optional[torch.Tensor] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   page_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SPA-Cache attention block step.  h: [B, N, d] current inputs;
    ``cache_sl`` (this layer's buffers) is updated in place.  Returns
    (h_out, selected idx)."""
    strategy = resolve_strategy(cfg, strategy)
    b, n, d = h.shape
    w = layer_window(cfg, kind)
    if strategy.full_attn_ident:
        return _attn_out_identifier_block(cfg, kind, bp, cache_sl, h, k_upd,
                                          policy, strategy, kv_len=kv_len,
                                          page_table=page_table)

    # ---- Phase 1: identification & selection ----
    # Cosine drift is invariant to per-row scale: score on
    # h * (1 + norm_weight) and rms-norm only the k selected rows.
    ident_in = h * (1.0 + bp["norm1"]).to(h.dtype)
    scores, p_now, proxy_now = _identifier_scores(
        strategy, bp, proxy_mat, ident_in, cache_sl, scores_override,
        prev_idx, page_table)
    scores = _mask_tail_scores(scores, n, kv_len)
    # windowed layers on a long canvas select per stratum, which bounds the
    # span of a q block and lets attention run the banded grid
    nb = stratify_blocks_for(n, k_upd) if w > 0 else 0
    if nb > 1:
        idx = selection.select_stratified(scores, k_upd, nb)
        span = q_span_bound(n, k_upd, nb)
    else:
        idx = selection.select_topk_drift(scores, k_upd)
        span = 0
    k_eff = idx.shape[1]
    h_rows, x_rows = strategy.backend.gather_norm(h, idx, bp["norm1"],
                                                  cfg.norm_eps)

    # ---- Phase 2: attention with partially cached KV ----
    # K/V are committed BEFORE attention reads the cache.
    q, k_new, v_new = qkv_project(bp, x_rows, cfg, idx)
    strategy.commit_kv(cache_sl, idx, k_new, v_new, policy)
    kf, vf, ks, vs = cache_lib.read_kv_for_attention(cache_sl, policy)
    attn = strategy.backend.attention(
        q, kf, vf, k_scale=ks, v_scale=vs, q_positions=idx, window=w,
        soft_cap=cfg.attn_softcap, banded=(w > 0 and span > 0),
        q_span=span, kv_len=kv_len)
    attn_out = attn.reshape(b, k_eff, cfg.q_dim) @ bp["wo"]
    if cfg.post_norms:
        attn_out = common.rms_norm(attn_out, bp["norm_post_attn"],
                                   cfg.norm_eps)
    h_mid = h_rows + attn_out

    # ---- Phase 3: FFN & output update ----
    y = common.rms_norm(h_mid, bp["norm2"], cfg.norm_eps)
    ffn_out = apply_ffn_or_moe(bp, y, cfg)
    if cfg.post_norms:
        ffn_out = common.rms_norm(ffn_out, bp["norm_post_ffn"],
                                  cfg.norm_eps)
    y_rows = h_mid + ffn_out
    strategy.commit(cache_sl, idx, y_rows, policy, p_now=p_now,
                    proxy_now=proxy_now, page_table=page_table)
    return cache_lib.read_h_full(cache_sl, policy, h.dtype), idx


def _attn_out_identifier_block(cfg, kind, bp, cache_sl, h, k_upd, policy,
                               strategy, kv_len=None, page_table=None):
    """Table-1 'attn output' identifier: full attention for ALL rows
    against the (stale) cached K/V, for identification only; the drift of
    its output against the cached one selects the rows whose K/V, H and
    FFN are refreshed."""
    b, n, d = h.shape
    w = layer_window(cfg, kind)
    x = common.rms_norm(h, bp["norm1"], cfg.norm_eps)
    positions = torch.arange(n, device=h.device).expand(b, n)
    q_all, k_all, v_all = qkv_project(bp, x, cfg, positions)
    kf, vf, ks, vs = cache_lib.read_kv_for_attention(cache_sl, policy)
    attn_all = strategy.backend.attention(
        q_all, kf, vf, k_scale=ks, v_scale=vs, window=w,
        soft_cap=cfg.attn_softcap, banded=(w > 0), kv_len=kv_len)
    attn_all = attn_all.reshape(b, n, cfg.q_dim) @ bp["wo"]
    if cfg.post_norms:
        attn_all = common.rms_norm(attn_all, bp["norm_post_attn"],
                                   cfg.norm_eps)
    scores = strategy.backend.score_drift(strategy, attn_all,
                                          cache_sl["proxy"],
                                          page_table=page_table)
    scores = _mask_tail_scores(scores, n, kv_len)
    idx = selection.select_topk_drift(scores, k_upd)

    strategy.commit_kv(cache_sl, idx, selection.gather_rows(k_all, idx),
                       selection.gather_rows(v_all, idx), policy)
    h_mid = selection.gather_rows(h, idx) + selection.gather_rows(
        attn_all, idx)
    y = common.rms_norm(h_mid, bp["norm2"], cfg.norm_eps)
    ffn_out = apply_ffn_or_moe(bp, y, cfg)
    if cfg.post_norms:
        ffn_out = common.rms_norm(ffn_out, bp["norm_post_ffn"],
                                  cfg.norm_eps)
    y_rows = h_mid + ffn_out
    strategy.commit(cache_sl, idx, y_rows, policy, attn_all=attn_all,
                    page_table=page_table)
    return cache_lib.read_h_full(cache_sl, policy, h.dtype), idx


# ---------------------------------------------------------------------------
# Whole-model serve forward
# ---------------------------------------------------------------------------

def _homogeneous_attention(cfg: ModelConfig) -> bool:
    kinds = set(cfg.layer_pattern)
    return len(kinds) == 1 and next(iter(kinds)) in ATTENTION_KINDS


def layer_ks(cfg: ModelConfig, strategy: CacheStrategy, n: int, *,
             scores_override: bool = False) -> List[int]:
    """The k each layer runs with, as the JAX package runs it: bucketed
    (one k per scan segment) for homogeneous all-attention models of 8 or
    more layers with ``scan_layers`` and no score override (the window
    strategy's), the exact schedule otherwise."""
    ks = strategy.k_schedule(cfg, n)
    if (_homogeneous_attention(cfg) and cfg.scan_layers
            and cfg.n_layers >= 8 and not scores_override):
        out = list(ks)
        for a, b_end, kseg in budget.bucketize(ks, strategy.n_buckets):
            out[a:b_end] = [kseg] * (b_end - a)
        return out
    return list(ks)


def spa_forward(params: Params, cfg: ModelConfig,
                cache: Dict[str, Dict[str, torch.Tensor]], h: torch.Tensor,
                spa_proxies: Optional[Dict[str, torch.Tensor]] = None,
                scores_override: Optional[torch.Tensor] = None,
                changed_idx: Optional[torch.Tensor] = None,
                strategy: Optional[CacheStrategy] = None, backend=None,
                kv_len: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Run all blocks with the strategy on attention layers.  ``cache``
    ({kind: {name: [Lk, B, N, ...]}}) is updated in place and returned;
    with ``page_table`` [B, n_log] its ``proxy`` buffers are page arenas
    [Lk, P, page, r].  ``scores_override`` [B, N] replaces identification
    on every layer; ``changed_idx`` [B, c] (the committed ring, -1 unused)
    names the rows whose inputs changed since the previous step, for the
    incremental identifier.  Returns (h_final, cache)."""
    strategy = resolve_strategy(cfg, strategy)
    if backend is not None:
        strategy = strategy.with_backend(backend)
    policy = CachePolicy.from_config(cfg)
    b, n = h.shape[0], h.shape[1]
    ks = layer_ks(cfg, strategy, n,
                  scores_override=scores_override is not None)
    k_max = max(ks)
    incremental = strategy.incremental and scores_override is None

    def pad_idx(idx):
        """Pad or clip an index set to [B, k_max] with the sentinel n."""
        if idx is None:
            return torch.full((b, k_max), n, dtype=torch.int32,
                              device=h.device)
        idx = idx.to(torch.int32)
        idx = torch.where(idx < 0, n, idx)        # -1 ring slots
        if idx.shape[1] >= k_max:
            return idx[:, :k_max]
        return torch.nn.functional.pad(idx, (0, k_max - idx.shape[1]),
                                       value=n)

    prev = pad_idx(changed_idx) if incremental else None
    for l in range(cfg.n_layers):
        kind = cfg.kind_of_layer(l)
        ki = cfg.kind_index(l)
        bp = layer_params(params, cfg, l)
        if kind in ATTENTION_KINDS and strategy.uses_cache:
            csl = {name: t[ki] for name, t in cache[kind].items()}
            prox = (spa_proxies[kind][ki]
                    if strategy.uses_proxy_mat and spa_proxies else None)
            h, idx = spa_attn_block(cfg, kind, bp, prox, csl, h, ks[l],
                                    policy, strategy,
                                    scores_override=scores_override,
                                    prev_idx=prev, kv_len=kv_len,
                                    page_table=page_table)
            if incremental:
                prev = pad_idx(idx)
        else:
            h, _ = apply_block_dense(cfg, kind, bp, h, strategy=strategy,
                                     kv_len=kv_len)
            # a recurrent block recomputes every row, so every input of
            # the next attention layer changed: full identification there
            if incremental and kind not in ATTENTION_KINDS:
                prev = None
    return h, cache
