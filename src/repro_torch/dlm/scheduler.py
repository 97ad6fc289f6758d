"""Unmask schedulers (the ``UnmaskScheduler`` protocol), as in the JAX
package: a frozen dataclass with one method,

    commit, pred = scheduler.select_commits(view)

where ``view`` (a :class:`CommitView`) exposes this step's candidates.
This slice ports the default greedy ``confidence`` scheduler; the
parallel, entropy, temperature, random-order and block schedulers wait for
a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Optional, Tuple

import torch


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


def _argmax_commit(conf: torch.Tensor) -> torch.Tensor:
    """One-hot bool mask of the per-row argmax (first maximum)."""
    hot = torch.zeros(conf.shape, dtype=torch.bool, device=conf.device)
    hot.scatter_(-1, torch.argmax(conf, dim=-1, keepdim=True), True)
    return hot


@dataclasses.dataclass(frozen=True)
class UnmaskScheduler:
    """Protocol base: frozen, hashable commit policy."""

    name: ClassVar[str] = "abstract"

    def select_commits(self, view: CommitView
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (commit [B, C] bool, pred [B, C] token ids)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConfidenceScheduler(UnmaskScheduler):
    """Greedy argmax-confidence: exactly one commit per row per step."""

    name: ClassVar[str] = "confidence"

    def select_commits(self, view):
        return _argmax_commit(view.conf), view.pred


def resolve_scheduler(settings=None,
                      scheduler: Optional[UnmaskScheduler] = None
                      ) -> UnmaskScheduler:
    """Call-time scheduler wins, else greedy confidence.  The legacy
    parallel-threshold knobs map to a scheduler of a later slice."""
    if scheduler is not None:
        return scheduler
    if settings is not None and settings.parallel_threshold > 0.0:
        raise NotImplementedError(
            "the parallel-threshold scheduler waits for a later slice")
    return ConfidenceScheduler()
