"""DLM iterative-unmasking decode primitives with pluggable caching.

  prefill    — full forward over the canvas that builds the strategy's
               layer caches (K, V, H^c, identifier vectors).
  serve_step — ONE refinement step: sparse layer updates driven by the
               strategy, candidate-limited logits, and the commit decision
               of an ``UnmaskScheduler``.

The step loop lives in ``repro_torch.dlm.session.DecodeSession``;
``decode`` and ``decode_semi_ar`` below are thin compatibility wrappers
over it.  Logits are evaluated only at ``n_candidates`` open positions per
step.  Every top-k here breaks ties lowest index first, like
``jax.lax.top_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core import selection, spa_layer
from repro_torch.core.cache import CachePolicy
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.dlm.scheduler import (CommitView, UnmaskScheduler,
                                       resolve_scheduler)
from repro_torch.models import transformer

Params = Dict[str, Any]


class DecodeState(NamedTuple):
    tokens: torch.Tensor         # [B, N] canvas (mask_id at open slots)
    cache: Any                   # {kind: {name: [Lk,B,N,...]}} or a
    #                              PagedCache; updated in place
    step: int
    committed: torch.Tensor      # [B, C] recently committed positions (-1)
    n_masked: torch.Tensor       # [B] remaining masked counts
    active: Optional[torch.Tensor] = None   # [B, N] bool commit mask
    kv_len: Optional[torch.Tensor] = None   # [B] valid canvas length
    # the stochastic schedulers' random numbers (a ``scheduler.Draws``:
    # a seeded torch.Generator, or recorded draws replayed in order)
    rng: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class DecodeSettings:
    """Per-request decode knobs (see the JAX package's ``DecodeSettings``).

    ``refresh_interval``: R > 0 rebuilds the cache every R steps, 0 falls
    back to the strategy's default and -1 disables refresh.
    ``parallel_threshold``/``max_parallel`` are the legacy spec form of the
    commit policy: ``resolve_scheduler`` maps them to a
    ``ParallelThresholdScheduler``."""
    n_candidates: int = 64
    parallel_threshold: float = 0.0   # 0 = commit exactly 1 token / step
    max_parallel: int = 0             # cap on tokens committed per step
    refresh_interval: int = 0
    commit_ring: int = 8


def prefill(params: Params, cfg: ModelConfig,
            inputs: Dict[str, torch.Tensor], spa_proxies=None,
            strategy: Optional[CacheStrategy] = None,
            kv_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full forward building the strategy's caches. Returns (h, cache)."""
    strategy = resolve_strategy(cfg, strategy)
    policy = CachePolicy.from_config(cfg)
    h = transformer.embed_inputs(params, cfg, inputs)
    h, raw = transformer.forward_hidden(
        params, cfg, h, collect_cache=True, spa_proxies=spa_proxies,
        strategy=strategy, kv_len=kv_len)
    return h, {kind: cache_lib.fill_from_prefill(entries, policy,
                                                 strategy.incremental)
               for kind, entries in (raw or {}).items()}


def _candidate_positions(tokens: torch.Tensor, mask_id: int, n_cand: int,
                         active: Optional[torch.Tensor] = None):
    """First n_cand open (masked AND active) positions per row, sorted;
    with fewer open slots the rest are the lowest closed positions (the
    ``-inf`` ties of the JAX top-k)."""
    b, n = tokens.shape
    is_masked = tokens == mask_id
    if active is not None:
        is_masked = is_masked & active
    pos = torch.arange(n, device=tokens.device, dtype=torch.float32)
    score = torch.where(is_masked, -pos[None, :], -torch.inf)
    idx = selection.topk_lowest_first(score, min(n_cand, n))
    return torch.sort(idx, dim=-1).values.to(torch.int32), is_masked


def serve_step(params: Params, cfg: ModelConfig, state: DecodeState,
               settings: DecodeSettings, spa_proxies=None,
               strategy: Optional[CacheStrategy] = None,
               scheduler: Optional[UnmaskScheduler] = None
               ) -> Tuple[DecodeState, Dict[str, torch.Tensor]]:
    """One diffusion refinement step under the resolved strategy; the
    cache is updated in place."""
    strategy = resolve_strategy(cfg, strategy)
    scheduler = resolve_scheduler(settings, scheduler)
    tokens, cache = state.tokens, state.cache
    mask_id = cfg.mask_id

    h = transformer.embed_inputs(params, cfg, {"tokens": tokens})
    n = h.shape[1]
    scores_override = strategy.pre_scores(n, state.committed)
    # Paged cache: every buffer but the identifier pages is gathered into
    # a dense view through the page table, the step runs on it and the
    # view is scattered back; all through strategy.backend.
    paged = isinstance(cache, cache_lib.PagedCache)
    view = (cache_lib.paged_step_view(cache, backend=strategy.backend)
            if paged else cache)
    if not strategy.uses_cache or not view:
        h, _ = transformer.forward_hidden(params, cfg, h, strategy=strategy,
                                          kv_len=state.kv_len)
    else:
        h, view = spa_layer.spa_forward(
            params, cfg, view, h, spa_proxies=spa_proxies,
            scores_override=scores_override, changed_idx=state.committed,
            strategy=strategy, kv_len=state.kv_len,
            page_table=cache.page_table if paged else None)
        cache = (cache_lib.paged_step_commit(cache, view,
                                             backend=strategy.backend)
                 if paged else view)

    # Candidate-limited logit evaluation + commit.
    cand_idx, is_masked = _candidate_positions(
        tokens, mask_id, settings.n_candidates, state.active)
    h_cand = selection.gather_rows(h, cand_idx)
    logits = transformer.logits_from_hidden(params, cfg, h_cand)
    # the model must never commit the [MASK] token itself
    logits[..., mask_id] = -torch.inf
    probs = torch.softmax(logits, dim=-1)
    conf = probs.amax(dim=-1)                          # [B, n_cand]
    pred = torch.argmax(probs, dim=-1).to(tokens.dtype)

    cand_is_masked = torch.gather(is_masked, 1, cand_idx.long())
    conf = torch.where(cand_is_masked, conf, -torch.inf)

    # The commit decision is the scheduler's; a stochastic one draws its
    # random numbers from the state's source, which advances in place.
    if scheduler.uses_rng and state.rng is None:
        raise ValueError(f"scheduler {scheduler.name!r} needs an rng: pass "
                         "rng= to DecodeSession.prefill()/attach()")
    active = state.active if state.active is not None \
        else torch.ones_like(tokens, dtype=torch.bool)
    view = CommitView(
        logits=logits, conf=conf, pred=pred, cand_idx=cand_idx,
        cand_open=cand_is_masked, open_mask=is_masked, active=active,
        rng=state.rng if scheduler.uses_rng else None)
    commit, pred = scheduler.select_commits(view)
    commit = commit & cand_is_masked

    old = torch.gather(tokens, 1, cand_idx.long())
    new_tokens = tokens.clone()
    new_tokens.scatter_(1, cand_idx.long(), torch.where(commit, pred, old))

    committed_pos = torch.where(commit, cand_idx, -1)
    ring = settings.commit_ring
    order = selection.topk_lowest_first(committed_pos.float(),
                                        min(ring, committed_pos.shape[-1]))
    committed = torch.gather(committed_pos, 1, order)
    if committed.shape[-1] < ring:
        committed = torch.nn.functional.pad(
            committed, (0, ring - committed.shape[-1]), value=-1)

    n_committed = commit.sum(dim=-1).to(state.n_masked.dtype)
    new_state = DecodeState(
        tokens=new_tokens, cache=cache, step=state.step + 1,
        committed=committed, n_masked=state.n_masked - n_committed,
        active=state.active, kv_len=state.kv_len, rng=state.rng)
    info = {"n_committed": n_committed,
            "mean_conf": torch.where(torch.isfinite(conf), conf,
                                     torch.zeros_like(conf)).mean(),
            "row_finite": torch.isfinite(h).all(dim=2).all(dim=1)}
    return new_state, info


# ---------------------------------------------------------------------------
# Compatibility wrappers over DecodeSession
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, params: Params,
                      prompt: torch.Tensor, gen_len: int, spa_proxies=None,
                      use_cache: bool = True,
                      strategy: Optional[CacheStrategy] = None,
                      settings: Optional[DecodeSettings] = None,
                      device=None) -> DecodeState:
    """Deprecated: use ``DecodeSession.prefill``; kept for old callers."""
    from repro_torch.dlm.session import DecodeSession
    sess = DecodeSession(params, cfg, strategy=strategy, settings=settings,
                         spa_proxies=spa_proxies, device=device)
    return sess.prefill(prompt, gen_len, use_cache=use_cache)


def decode(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
           gen_len: int, settings: Optional[DecodeSettings] = None,
           spa_proxies=None, max_steps: Optional[int] = None,
           strategy: Optional[CacheStrategy] = None,
           scheduler: Optional[UnmaskScheduler] = None, rng=None,
           device=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the unmasking loop until every slot is committed (a wrapper
    over ``DecodeSession``)."""
    from repro_torch.dlm.session import DecodeSession
    sess = DecodeSession(params, cfg, strategy=strategy, settings=settings,
                         spa_proxies=spa_proxies, scheduler=scheduler,
                         device=device)
    sess.prefill(prompt, gen_len, rng=rng)
    return sess.run(max_steps)


def decode_semi_ar(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                   gen_len: int, block_len: int = 8,
                   settings: Optional[DecodeSettings] = None,
                   spa_proxies=None,
                   strategy: Optional[CacheStrategy] = None,
                   scheduler: Optional[UnmaskScheduler] = None, rng=None,
                   device=None):
    """Block-wise semi-AR decoding: the canvas unmasks block by block,
    left to right, through the session's active-position mask, with a
    cache refresh at each block boundary (a wrapper over
    ``DecodeSession.run_blocks``)."""
    from repro_torch.dlm.session import DecodeSession
    sess = DecodeSession(params, cfg, strategy=strategy, settings=settings,
                         spa_proxies=spa_proxies, scheduler=scheduler,
                         device=device)
    sess.prefill(prompt, gen_len, rng=rng)
    return sess.run_blocks(block_len)
