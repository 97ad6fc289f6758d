"""Deterministic fault injection for the serving runtime (the JAX package's
``serving/faults.py``).

A seeded :class:`FaultPlan` is threaded through the engine's seams and
replays bit for bit from its seed, so a chaos run is a regression test.

Fault sites (one seam each in the engine or the tier):

  ``pool_alloc``    a page-pool allocation fails transiently (admission,
                    publication and promotion allocations all probe it); the
                    supervisor's bounded retry with backoff absorbs it.
  ``host_store``    the host tier refuses a demotion write (the victim is
                    dropped instead, the tier's graceful path).
  ``host_corrupt``  a freshly demoted host page is bit-flipped in place; the
                    checksum on promotion catches it and the engine falls
                    back to a cold prefill.
  ``step_nan``      one live row's cache pages are poisoned with NaN; the
                    next step's hidden states go non-finite and the
                    supervisor's canvas guard quarantines the row.
  ``lane_stall``    the lane's step stops being launched (sticky: a hung
                    device) until the supervisor's step-clock watchdog
                    force-preempts the lane.
  ``disconnect``    every streaming request of the batch hangs up at once
                    (a burst of cancellations).

Determinism: probe ``k`` of site ``s`` draws ``crc32(f"{seed}:{s}:{k}")``,
``k`` the site's own probe counter: no global random state, no wall clock.
Two runs that make the same probe sequence fire the same faults at the same
sites, abort the same uids and leave the same survivors, in this package
and in the JAX one.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

FAULT_SITES = ("pool_alloc", "host_store", "host_corrupt", "step_nan",
               "lane_stall", "disconnect")


def _hash01(seed: int, site: str, k: int) -> float:
    """Uniform [0, 1) draw for probe ``k`` of ``site``: crc32, so it is the
    same on every platform, under any Python hash seed, and in both
    packages."""
    return zlib.crc32(f"{seed}:{site}:{k}".encode()) / 2 ** 32


def flip_first_word(a) -> None:
    """Flip the first 8 bytes of ``a`` (a contiguous tensor or numpy array)
    in place: the smallest bit rot a checksum must catch."""
    if isinstance(a, torch.Tensor):
        flat = a.reshape(-1).view(torch.uint8)
        flat[:8].bitwise_xor_(0xFF)
    else:
        flat = a.reshape(-1).view(np.uint8)
        flat[:8] ^= 0xFF


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A replayable chaos schedule.

    ``rates`` maps a fault site to its firing probability a probe (a
    storm); ``at`` maps a site to probe indices that fire once each
    (targeted tests).  A site may appear in both: either trigger fires it.
    ``max_fires`` caps the fires of a site, so a burst can go quiet and let
    the degradation ladder walk back down."""
    seed: int = 0
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    at: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    max_fires: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for m in (self.rates, self.at, self.max_fires):
            for site in m:
                if site not in FAULT_SITES:
                    raise ValueError(f"unknown fault site {site!r}; "
                                     f"known: {FAULT_SITES}")
        # own copies, so the caller's mappings cannot change the plan
        object.__setattr__(self, "rates", dict(self.rates))
        object.__setattr__(self, "at",
                           {s: tuple(v) for s, v in self.at.items()})
        object.__setattr__(self, "max_fires", dict(self.max_fires))


class FaultInjector:
    """Runtime state of one engine run under a :class:`FaultPlan`.

    The engine probes ``fire(site)`` at each seam; the injector keeps a
    probe counter a site and a ``log`` of every fire ``(site, probe)``: the
    replay fingerprint two runs under one plan share."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._probes: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self.fired: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self.log: List[Tuple[str, int]] = []
        # called with every logged (site, probe): the engine writes fires
        # into its trace with the log's schema
        self.on_fire = None
        # sticky lane stalls: lane key -> True until the watchdog clears it
        self._stalled: Dict[object, bool] = {}

    def fire(self, site: str) -> bool:
        """One probe of ``site``; True when the plan says to inject."""
        k = self._probes[site]
        self._probes[site] = k + 1
        if self.fired[site] >= self.plan.max_fires.get(site, 1 << 30):
            return False
        hit = k in self.plan.at.get(site, ())
        rate = self.plan.rates.get(site, 0.0)
        if not hit and rate > 0.0:
            hit = _hash01(self.plan.seed, site, k) < rate
        if hit:
            self.fired[site] += 1
            self.log.append((site, k))
            if self.on_fire is not None:
                self.on_fire(site, k)
        return hit

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def stall_lane(self, lane_id: object) -> bool:
        """Probe ``lane_stall`` for a running lane; once fired the lane stays
        stalled (every step skipped) until :meth:`clear_stall`, which only
        the watchdog's forced preemption calls."""
        if self._stalled.get(lane_id):
            return True
        if self.fire("lane_stall"):
            self._stalled[lane_id] = True
            return True
        return False

    def clear_stall(self, lane_id: object) -> None:
        self._stalled.pop(lane_id, None)

    def corrupt_array(self, a) -> None:
        """Flip the first 8 bytes of ``a`` in place (a host tier slot: a
        pinned tensor; or a numpy array)."""
        flip_first_word(a)


def choose_index(seed: int, salt: str, k: int, n: int) -> int:
    """Index in [0, n) for fire ``k``: which live row a ``step_nan`` fault
    poisons."""
    assert n > 0
    return zlib.crc32(f"{seed}:{salt}:{k}".encode()) % n
