"""Unmask schedulers (the ``UnmaskScheduler`` protocol), as in the JAX
package: a frozen dataclass with one method,

    commit, pred = scheduler.select_commits(view)

where ``view`` (a :class:`CommitView`) exposes this step's candidates.
``commit`` is a [B, C] bool mask over candidates and ``pred`` the [B, C]
token ids to write where committed; ``serve_step`` intersects ``commit``
with the open-candidate flags.

Registered: ``confidence`` (greedy, the default), ``parallel`` (Fast-dLLM
threshold), ``entropy``, ``temperature`` and ``random_order`` (stochastic)
and ``block`` (semi-AR blocks as data).

Stochastic schedulers (``uses_rng``) take their random numbers from a
:class:`Draws` source held in the decode state: :class:`GeneratorDraws`
wraps a seeded ``torch.Generator`` on the session's device; another source
can replay recorded draws (the parity tests feed the JAX package's, as the
two frameworks' generators give different numbers from one seed).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.core.selection import topk_lowest_first

SCHEDULERS: Dict[str, Type["UnmaskScheduler"]] = {}


def register(name: str):
    def deco(cls):
        SCHEDULERS[name] = cls
        return cls

    return deco


class Draws:
    """Source of a stochastic scheduler's random numbers.  Each call
    returns a new f32 tensor of ``shape`` on ``device``."""

    def uniform(self, shape, device) -> torch.Tensor:
        raise NotImplementedError

    def gumbel(self, shape, device) -> torch.Tensor:
        raise NotImplementedError


class GeneratorDraws(Draws):
    """Draws from a ``torch.Generator`` (advanced in place)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, device):
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(device)

    def gumbel(self, shape, device):
        # -log(-log(u)) with u in [tiny, 1), as jax.random.gumbel draws it
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(shape, device).clamp_min(tiny)
        return -torch.log(-torch.log(u))


class CommitView(NamedTuple):
    """Everything a scheduler may look at when picking commits
    (C = ``settings.n_candidates``)."""

    logits: torch.Tensor         # [B, C, V] ([MASK] already -inf)
    conf: torch.Tensor           # [B, C] max prob, -inf at closed cands
    pred: torch.Tensor           # [B, C] greedy token ids
    cand_idx: torch.Tensor       # [B, C] canvas positions of candidates
    cand_open: torch.Tensor      # [B, C] candidate is masked AND active
    open_mask: torch.Tensor      # [B, N] full canvas open mask
    active: torch.Tensor         # [B, N] full active-position mask
    rng: Optional[Draws] = None  # uses_rng schedulers only


def _argmax_commit(conf: torch.Tensor) -> torch.Tensor:
    """One-hot bool mask of the per-row argmax (first maximum)."""
    hot = torch.zeros(conf.shape, dtype=torch.bool, device=conf.device)
    hot.scatter_(-1, torch.argmax(conf, dim=-1, keepdim=True), True)
    return hot


def _commit_with_parallel(score: torch.Tensor, par: Optional[torch.Tensor],
                          max_parallel: int) -> torch.Tensor:
    """Fast-dLLM parallel commit: the argmax-``score`` candidate plus every
    candidate in ``par``, optionally capped at the ``max_parallel``
    highest-scoring (ties lowest index first, as ``jax.lax.top_k``)."""
    commit = _argmax_commit(score)
    if par is not None:
        if max_parallel > 0:
            topp = topk_lowest_first(score, min(max_parallel,
                                                score.shape[-1]))
            in_top = torch.zeros_like(par)
            in_top.scatter_(-1, topp, True)
            par = par & in_top
        commit = commit | par
    return commit


@dataclasses.dataclass(frozen=True)
class UnmaskScheduler:
    """Protocol base: frozen, hashable commit policy."""

    name: ClassVar[str] = "abstract"
    uses_rng: ClassVar[bool] = False   # True -> the state carries Draws

    def select_commits(self, view: CommitView
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (commit [B, C] bool, pred [B, C] token ids)."""
        raise NotImplementedError


@register("confidence")
@dataclasses.dataclass(frozen=True)
class ConfidenceScheduler(UnmaskScheduler):
    """Greedy argmax-confidence: exactly one commit per row per step."""

    name: ClassVar[str] = "confidence"

    def select_commits(self, view):
        return _argmax_commit(view.conf), view.pred


@register("parallel")
@dataclasses.dataclass(frozen=True)
class ParallelThresholdScheduler(UnmaskScheduler):
    """Fast-dLLM-style parallel commit: the most confident candidate plus
    every candidate above ``threshold`` (capped at ``max_parallel``)."""

    threshold: float = 0.05
    max_parallel: int = 0            # 0 = uncapped

    name: ClassVar[str] = "parallel"

    def select_commits(self, view):
        par = (view.conf > self.threshold) if self.threshold > 0.0 \
            else None
        return _commit_with_parallel(view.conf, par,
                                     self.max_parallel), view.pred


@register("entropy")
@dataclasses.dataclass(frozen=True)
class EntropyScheduler(UnmaskScheduler):
    """Commit the minimum-entropy candidate; ``threshold`` > 0 also
    commits every candidate whose entropy (nats) is below it, capped at
    ``max_parallel``."""

    threshold: float = 0.0
    max_parallel: int = 0

    name: ClassVar[str] = "entropy"

    def select_commits(self, view):
        probs = torch.softmax(view.logits, dim=-1)
        ent = -torch.sum(probs * torch.log(probs.clamp_min(1e-30)), dim=-1)
        # negated: the shared parallel helper expects HIGH = commit
        neg_ent = torch.where(view.cand_open, -ent, -torch.inf)
        par = (neg_ent > -self.threshold) if self.threshold > 0.0 \
            else None
        return _commit_with_parallel(neg_ent, par,
                                     self.max_parallel), view.pred


@register("temperature")
@dataclasses.dataclass(frozen=True)
class TemperatureSampler(UnmaskScheduler):
    """Stochastic commit: the position is sampled ∝ softmax(conf / T) over
    open candidates (Gumbel-max) and the token from softmax(logits / T).
    Draws, in order: the token noise [B, C, V], then the position noise
    [B, C]."""

    temperature: float = 1.0

    name: ClassVar[str] = "temperature"
    uses_rng: ClassVar[bool] = True

    def select_commits(self, view):
        t = max(self.temperature, 1e-6)
        dev = view.logits.device
        g_tok = view.rng.gumbel(view.logits.shape, dev)
        g_pos = view.rng.gumbel(view.conf.shape, dev)
        pred = torch.argmax(view.logits.float() / t + g_tok,
                            dim=-1).to(view.pred.dtype)
        score = torch.where(view.cand_open, view.conf / t + g_pos,
                            -torch.inf)
        return _argmax_commit(score), pred


@register("random_order")
@dataclasses.dataclass(frozen=True)
class RandomOrderScheduler(UnmaskScheduler):
    """Uniformly random unmask order with greedy tokens (the order
    ablation).  Draws a uniform [B, C] a step."""

    name: ClassVar[str] = "random_order"
    uses_rng: ClassVar[bool] = True

    def select_commits(self, view):
        u = view.rng.uniform(view.conf.shape, view.conf.device)
        score = torch.where(view.cand_open, u, -torch.inf)
        return _argmax_commit(score), view.pred


@register("block")
@dataclasses.dataclass(frozen=True)
class BlockScheduler(UnmaskScheduler):
    """Semi-AR blocks as data: commits are restricted to the current
    ``block_len``-wide window of the generation span (the leftmost open
    position defines it), with confidence and an optional parallel
    threshold inside the window."""

    block_len: int = 8
    threshold: float = 0.0
    max_parallel: int = 0

    name: ClassVar[str] = "block"

    def select_commits(self, view):
        b, n = view.active.shape
        pos = torch.arange(n, device=view.active.device)[None, :]
        big = torch.full_like(pos, n)
        gen_start = torch.where(view.active, pos, big).amin(dim=-1)   # [B]
        first_open = torch.where(view.open_mask, pos, big).amin(dim=-1)
        blk = torch.clamp(first_open - gen_start, min=0) // self.block_len
        win_lo = gen_start + blk * self.block_len
        win_hi = win_lo + self.block_len
        cand = view.cand_idx.long()
        in_win = (cand >= win_lo[:, None]) & (cand < win_hi[:, None])
        conf = torch.where(in_win, view.conf, -torch.inf)
        par = (conf > self.threshold) if self.threshold > 0.0 else None
        return _commit_with_parallel(conf, par,
                                     self.max_parallel), view.pred


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def scheduler_from_name(name: str, **kw) -> UnmaskScheduler:
    cls = SCHEDULERS.get(name)
    if cls is None:
        raise ValueError(f"unknown scheduler {name!r}; registered: "
                         f"{sorted(SCHEDULERS)}")
    return cls(**kw)


def resolve_scheduler(settings=None,
                      scheduler: Optional[UnmaskScheduler] = None
                      ) -> UnmaskScheduler:
    """Call-time scheduler wins; else the legacy ``DecodeSettings``
    parallel knobs map onto ``ParallelThresholdScheduler``; else greedy
    confidence."""
    if scheduler is not None:
        return scheduler
    if settings is not None and settings.parallel_threshold > 0.0:
        return ParallelThresholdScheduler(
            threshold=settings.parallel_threshold,
            max_parallel=settings.max_parallel)
    return ConfidenceScheduler()
