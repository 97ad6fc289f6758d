"""SLO-aware serving policy (the JAX package's ``serving/slo.py``).

Online serving is judged by *goodput*: requests completed within their
latency SLO per unit time, not batch completion time.  This module defines
the request-level SLO contract and the admission policy that maps it onto
the engine's priority + preemption machinery:

  * :class:`SLO` — per-request targets: time to first token (TTFT) and an
    end-to-end completion deadline, both in clock seconds from submission.
  * :class:`SLOPolicy` — the scheduling policy.  Near-deadline requests
    (TTFT slack below ``urgency_frac`` of their target) get a priority
    *boost*, which both reorders the admission queue ahead of slack-rich
    requests and lets them preempt strictly lower-priority running rows.
    Within one effective priority, candidates order by TTFT slack
    (earliest deadline first) instead of FIFO.  Hopeless requests (the
    TTFT deadline missed while still queued, or the e2e deadline passed)
    are *shed*: they can no longer count toward goodput.
  * :class:`StepClock` — a virtual clock: the engine reads time through an
    injectable ``clock`` callable, and arrival-process runs advance a
    StepClock by a fixed tick per engine step, so their latencies count
    engine steps and do not depend on the machine.

The policy reads only duck-typed request fields (``priority``, ``slo``,
``submitted_at``, ``first_token_at``), so it does not import the engine.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets, in clock seconds from submission.

    ``ttft``     — time to first committed token.
    ``deadline`` — end-to-end completion deadline.

    ``inf`` disables a bound; a request with no :class:`SLO` at all is
    treated as trivially met when it completes (completing it *is* the
    goodput).
    """
    ttft: float = math.inf
    deadline: float = math.inf

    def met(self, ttft: float, e2e: float) -> bool:
        return ttft <= self.ttft and e2e <= self.deadline


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """SLO-aware admission policy knobs.

    ``boost``        — priority increment for urgent (low-TTFT-slack)
                       requests; rides the engine's existing strict
                       priority ordering and preemption rules.
    ``urgency_frac`` — a request is urgent once its remaining TTFT
                       slack drops below ``urgency_frac * slo.ttft``
                       (scale-free: tight targets urge sooner in
                       absolute terms).
    ``shed``         — drop hopeless requests (missed TTFT while still
                       queued / e2e deadline passed) instead of serving
                       them to completion for zero goodput.
    """
    boost: int = 1
    urgency_frac: float = 0.5
    shed: bool = True

    # -- request-level predicates (duck-typed: engine Request) ---------

    def ttft_slack(self, req, now: float) -> float:
        """Seconds until the TTFT deadline (inf when untargeted or
        already met)."""
        if req.slo is None or not math.isfinite(req.slo.ttft):
            return math.inf
        if req.first_token_at is not None:      # TTFT already settled
            return math.inf
        return (req.submitted_at + req.slo.ttft) - now

    def urgent(self, req, now: float) -> bool:
        slack = self.ttft_slack(req, now)
        return (math.isfinite(slack)
                and slack < self.urgency_frac * req.slo.ttft)

    def effective_priority(self, req, now: float) -> int:
        return req.priority + (self.boost if self.urgent(req, now) else 0)

    def hopeless(self, req, now: float, margin: float = 0.0) -> bool:
        """True when the request can no longer contribute goodput.

        ``margin`` (seconds) tightens both deadlines (a degradation
        ladder sheds earlier under fault pressure)."""
        if req.slo is None:
            return False
        if (req.first_token_at is None
                and now > req.submitted_at + req.slo.ttft - margin):
            return True                          # TTFT missed in queue
        return now > req.submitted_at + req.slo.deadline - margin


class StepClock:
    """Deterministic virtual clock: ``tick`` seconds per ``advance()``.

    Inject as ``ServingEngine(clock=...)`` and advance once per engine
    step (e.g. from an ``on_step`` hook): every latency the engine
    records (TTFT/TPOT/e2e/queue wait) then counts engine steps instead
    of host wall time, the same on every machine."""

    def __init__(self, tick: float = 1.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float = None) -> None:
        self.t += self.tick if dt is None else dt
