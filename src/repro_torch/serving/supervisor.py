"""Engine supervisor: invariants, quarantine, watchdog, degradation (the JAX
package's ``serving/supervisor.py``).

The containment half of fault tolerance; the injection half is
:mod:`repro_torch.serving.faults`.  An :class:`EngineSupervisor` attaches
to a :class:`~repro_torch.serving.engine.ServingEngine`, which calls it at
the quiescent point of each step-loop iteration.  Four services:

invariant checker
    Page accounting closes on every check: the pool's refcounts equal the
    holds of the engine (running and queued requests' ``pages`` and
    ``holds``) plus the index's pages, page for page; the host tier's
    resident slots equal the trie's host refs; each request's emitted-token
    count never shrinks; a finished request's output never changes.  A
    violation raises :class:`InvariantViolation` at once.

NaN/Inf canvas guard
    ``serve_step`` exports whether each row's hidden states are finite; the
    guard marks every live row that is not as faulted.  The engine aborts
    only those requests and requeues their lane-mates from preemption
    snapshots, so one poisoned canvas never taints a batch.

step-clock watchdog
    Counts consecutive loop iterations without progress (no commit, finish
    or swap).  Past its budget it tells the engine to force-preempt every
    live row and rebuild the lane: a stuck lane becomes a bounded-latency
    preemption instead of a deadlock.

degradation ladder
    Fault pressure in a window of steps (injector fires and the engine's
    own fault events) walks the service level L0 -> L3, shedding
    capability in a fixed order:

      L1  pause prefix publication (stop growing shared state)
      L2  + bypass the host tier (no demotions, no promotions)
      L3  + shed low-priority queued work, tighten SLO shedding

    and walks back one rung a quiet ``cooldown``.  Every move lands in
    ``EngineStats.degradation_events`` and in the trace as a ``ladder``
    instant.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.telemetry import PID_EVENTS


class InvariantViolation(AssertionError):
    """A serving-runtime accounting invariant failed to close."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_alloc_retries: int = 3     # admission alloc retries before abort
    watchdog_budget: int = 24      # no-progress iterations before recovery
    check_every: int = 1           # invariant-check cadence (iterations)
    pressure_window: int = 32      # steps a fault event stays "hot"
    escalate_at: int = 3           # hot events to climb one rung
    cooldown: int = 24             # quiet steps to descend one rung
    shed_below: int = 0            # L3: shed queued priority < this
    hopeless_margin: float = 0.0   # L3: extra slack (s) for SLO shedding


class EngineSupervisor:
    """Fault containment around a :class:`ServingEngine`'s step loop.

    Construction attaches the supervisor (``engine.supervisor = self``);
    the engine then calls :meth:`nan_guard`, :meth:`watchdog` and
    :meth:`on_iteration` from its lane loop and reads the ladder flags this
    object sets on it."""

    def __init__(self, engine, cfg: Optional[SupervisorConfig] = None):
        self.engine = engine
        self.cfg = cfg or SupervisorConfig()
        engine.supervisor = self
        self.level = 0
        self._events: Deque[int] = deque()   # steps of pressure events
        self._fired_seen = 0                 # injector fires adopted
        self._no_progress = 0
        self._iter = 0
        self._emitted_seen: Dict[int, int] = {}
        self._done_crc: Dict[int, int] = {}
        self._last_change = -(1 << 30)       # step of the last ladder move

    # ---- NaN/Inf canvas guard ---------------------------------------

    def nan_guard(self, info, slots) -> List[int]:
        """Mark live rows whose hidden states went non-finite this step.

        ``info["row_finite"]`` is a host array (or CPU tensor) of one bool
        a row.  Only rows with a live request count: released rows produce
        non-finite activations by design (fully masked attention).  Returns
        the poisoned rows; the engine aborts their requests and preempts
        their lane-mates."""
        row_finite = info.get("row_finite")
        if row_finite is None:
            return []
        finite = np.asarray(row_finite)
        bad = []
        for i, req in enumerate(slots):
            if req is None or req.canceled or req.fault is not None:
                continue
            if not bool(finite[i]):
                req.fault = "nan"
                bad.append(i)
        if bad:
            self.note_pressure("step_nan")
        return bad

    # ---- step-clock watchdog ----------------------------------------

    def lane_started(self) -> None:
        self._no_progress = 0

    def watchdog(self, progressed: bool) -> bool:
        """True when the lane used up its no-progress budget and must be
        force-preempted (the engine does the recovery)."""
        if progressed:
            self._no_progress = 0
            return False
        self._no_progress += 1
        if self._no_progress >= self.cfg.watchdog_budget:
            self._no_progress = 0
            return True
        return False

    # ---- fault pressure + degradation ladder ------------------------

    def note_pressure(self, kind: str) -> None:  # noqa: ARG002 - a tag
        self._events.append(self.engine.stats.steps)

    def on_iteration(self) -> None:
        """The per-iteration quiescent hook: adopt injector fires into the
        pressure window, move the ladder, run the invariant check."""
        eng = self.engine
        step = eng.stats.steps
        if eng.faults is not None:
            fired = eng.faults.total_fired
            for _ in range(fired - self._fired_seen):
                self._events.append(step)
            self._fired_seen = fired
            eng.stats.faults_injected = fired
        lo = step - self.cfg.pressure_window
        while self._events and self._events[0] <= lo:
            self._events.popleft()
        if (len(self._events) >= self.cfg.escalate_at and self.level < 3
                and step > self._last_change):
            self._set_level(self.level + 1, step)
        elif (not self._events and self.level > 0
              and step - self._last_change >= self.cfg.cooldown):
            self._set_level(self.level - 1, step)
        self._iter += 1
        if self._iter % max(1, self.cfg.check_every) == 0:
            self.check_invariants()

    def _set_level(self, new: int, step: int) -> None:
        eng = self.engine
        if new > self.level:
            eng.stats.degradations += 1
        else:
            eng.stats.restorations += 1
        eng._tr.instant(PID_EVENTS, 2, "ladder", cat="fault",
                        args={"from": self.level, "to": new, "step": step})
        self.level = new
        self._last_change = step
        eng.stats.degrade_level = new
        eng.stats.degradation_events.append((step, new))
        eng._publish_paused = new >= 1
        eng._host_tier_paused = new >= 2
        if eng.prefix is not None:
            eng.prefix.demote_paused = new >= 2
        eng._shed_low_priority = new >= 3
        eng._shed_below = self.cfg.shed_below
        eng._hopeless_margin = (self.cfg.hopeless_margin
                                if new >= 3 else 0.0)

    # ---- invariant checker ------------------------------------------

    def check_invariants(self) -> None:
        """Assert that the engine's accounting across tiers closes now."""
        eng = self.engine
        eng.stats.invariant_checks += 1
        for req in list(eng._running.values()):
            if req.emitted is not None:
                n = int(req.emitted.sum())
                seen = self._emitted_seen.get(req.uid, 0)
                if n < seen:
                    raise InvariantViolation(
                        f"req {req.uid}: emitted mask shrank {seen} -> {n}")
                self._emitted_seen[req.uid] = n
        for req in eng.done[-64:]:
            if req.output is None:
                continue
            crc = zlib.crc32(np.ascontiguousarray(req.output).tobytes())
            if self._done_crc.setdefault(req.uid, crc) != crc:
                raise InvariantViolation(
                    f"req {req.uid}: completed output mutated")
        if not eng.paged:
            return
        expected: Dict[int, int] = {}
        for req in list(eng._running.values()) + list(eng.queue):
            for p in (req.pages or []) + (req.holds or []):
                expected[p] = expected.get(p, 0) + 1
        if eng.prefix is not None:
            for p in eng.prefix.device_pages():
                expected[p] = expected.get(p, 0) + 1
        actual = eng.pool.refcounts
        if expected != actual:
            only_exp = {p: c for p, c in expected.items()
                        if actual.get(p) != c}
            only_act = {p: c for p, c in actual.items()
                        if expected.get(p) != c}
            raise InvariantViolation(
                f"page refcounts do not close: expected!={only_exp} "
                f"actual!={only_act}")
        if eng.pool.used != len(expected):
            raise InvariantViolation(
                f"pool.used={eng.pool.used} but {len(expected)} pages "
                f"accounted")
        if eng.host_pool is not None and eng.prefix is not None:
            if eng.host_pool.used_pages != eng.prefix.host_held_pages:
                raise InvariantViolation(
                    f"host tier: {eng.host_pool.used_pages} resident pages "
                    f"vs {eng.prefix.host_held_pages} trie refs")
