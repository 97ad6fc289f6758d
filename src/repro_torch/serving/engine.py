"""Batched DLM serving engine on DecodeSession (the JAX package's
``serving/engine.py``: continuous batching, the paged pool, admission and
preemption).

Requests (prompt + gen_len + optional per-request DecodeSettings /
CacheStrategy / UnmaskScheduler / priority) are padded onto fixed canvas
rows and served by a ``DecodeSession`` at step granularity: when a row
finishes, its slot is swapped for the next queued request mid-loop
(``DecodeSession.replace_rows``) while sibling rows keep stepping with
their evolved caches.  A request carries token ids only: as in the JAX
engine, a VLM (whose canvas needs per-row ``patches``) fails at its first
prefill with ``KeyError: 'patches'``; decode a VLM through
``DecodeSession.prefill(extras=)``.  A MoE model routes every canvas row,
the tail past a paged row's ``kv_len`` included, as the JAX engine does.

The queue is partitioned into lanes keyed on the
``(DecodeSettings, CacheStrategy, UnmaskScheduler)`` triple: a lane's batch
only admits requests with an identical triple (one session per lane).
Within a lane rows are independent, so for deterministic schedulers
continuous batching gives the same outputs as static batches.  Stochastic
schedulers (``uses_rng``) draw from one generator per lane, seeded anew
each time the lane's batch is attached, so their outputs depend on batch
composition and swap order (reproducible per engine configuration).

Paged mode (``pool_pages > 0``): a :class:`~repro_torch.serving.pool.PagePool`
owns one device arena of fixed-size pages per cache buffer; each request
allocates only the pages covering its own (page-aligned) prompt + gen span,
and the canvas tail past a row's ``kv_len`` maps to the pool's zero page,
masked out of attention and selection.  Admission is gated on free slots
and free pages; when the best candidate cannot fit, the engine preempts
strictly lower-priority running requests (lowest priority first, most
recently started first within a priority): their pages are released and
their canvas + commit-ring snapshot is requeued at the front.  A resumed
request re-prefills its cache from the snapshot, which equals a periodic
refresh at the resume step.

Prefix reuse (``prefix_cache=True``, paged mode): a
:class:`~repro_torch.serving.prefix.PrefixIndex` maps (row span, strategy,
prompt token runs) to refcounted page runs holding PREFILL-TIME states.
Admission consults the index: a full hit attaches every page and runs no
prefill forward; a partial hit attaches the matched prefix read-only and
prefills only the unmatched suffix (``decoding.prefill_partial``).  The
session copies attached pages into the request's own reserve pages right
before its first cache write (copy-on-write), so index pages never change.
Cold requests publish their prefill pages (a page copy, skipped when the
pool is short) into the index at admission, before the first step:
states taken at harvest have evolved with the decode and would break the
bit-exactness of full hits.  Under admission pressure, least-recently used
index entries with no readers are evicted before any running request is
preempted.

Host tier (``host_pages > 0`` with the prefix index): evicted index
entries are demoted to a :class:`~repro_torch.serving.hier.HostPagePool`
(pinned host memory on the card) instead of dropped; a hit on a demoted
entry is promoted back into fresh device pages before the request attaches
them.  Demotions read the live arenas on the stream behind the step in
flight; promotions write them without a host sync, landing before the next
step (``_tier_read`` / ``_tier_write``).  ``host_dtype`` picks the stored
representation (``"f32"``: exact; ``"int8"``; ``"auto"``: int8 for stable
pages).  A promotion whose checksum fails is served by a cold prefill.

Online serving (the front end in ``serving/frontend.py``):

  * **Thread-safe intake** — ``submit_threadsafe`` / ``cancel_threadsafe``
    validate on the caller and put closures on a mailbox that the engine
    thread drains; the engine's state is only touched on that thread.
  * **Double-buffered dispatch** — each loop iteration launches the step,
    then does its host work (mailbox drain, SLO shedding, the prefix plan of
    the next admission candidate: ``_host_overlap``) before the first host
    sync on the step's outputs, so that work overlaps the step on the card.
  * **Per-token events** — a request submitted with a ``sink`` (or with
    ``stream=True`` and an engine-level ``event_sink``) gets a
    :class:`RequestEvent` per batch of newly committed tokens, found by
    diffing the canvas against the request's emitted mask.  The mask lives
    on the ``Request``, so a preempted-then-resumed request streams every
    gen position exactly once.
  * **SLO-aware scheduling** — requests may carry an
    :class:`~repro_torch.serving.slo.SLO`; with an engine-level
    :class:`~repro_torch.serving.slo.SLOPolicy`, near-deadline requests are
    boosted onto the priority + preemption machinery and ordered earliest
    deadline first, and hopeless ones are shed.  ``EngineStats`` keeps
    TTFT / TPOT histograms and goodput under SLO.  All SLO arithmetic reads
    the engine's ``clock`` (a ``StepClock`` makes it count engine steps).
  * **Telemetry** — a :class:`~repro_torch.serving.telemetry.Telemetry`
    (registry + span tracer, off by default): request lifecycle spans,
    per-step ``dispatch`` / ``host_overlap`` / ``host_sync`` spans and
    counters, demote / promote instants, cache-dynamics sampling
    (``dynamics_every``), ``render_metrics`` (Prometheus text) and
    ``export_trace`` (Chrome trace JSON).

``cancel(uid)`` aborts a queued or running request and releases its
slot, pages and prefix read holds.

Fault tolerance (``fault_plan=``, ``supervise=``, ``supervisor_cfg=``): a
seeded :class:`~repro_torch.serving.faults.FaultPlan` fires faults at the
pool's allocation, the host tier's demotion (a refused store, a corrupted
page), a live row's cache pages (NaN), the lane's step (a stall) and the
streaming clients (a disconnect burst); the same plan replays the same
faults.  An :class:`~repro_torch.serving.supervisor.EngineSupervisor`
contains them: a bounded allocation retry with exponential backoff on the
step clock, a NaN guard that aborts only the poisoned rows (their
lane-mates resume from preemption snapshots), a step-clock watchdog that
force-preempts a stuck lane, an invariant check of the page accounting
every iteration, and a degradation ladder that pauses publication (L1),
bypasses the host tier (L2) and sheds low-priority work (L3) under fault
pressure.  A fault plan implies supervision.

Profiling (the JAX package's DESIGN.md §12): ``profiler=`` takes a
``serving.profiling.StepProfiler`` that every lane session fences its steps
into; the collector exports ``core.runtime``'s ``spa_runtime_*`` series and
``pool_debug_state`` the live-executable count.

Recurrent stacks (the RG-LRU hybrid, Mamba2's SSD) serve in dense and paged
lanes as the JAX engine serves them: recurrent layers carry no cache and
are recomputed every step, so only attention kinds get arenas (an SSD
stack's paged lanes have none, and its prefix index never hits).  As in
the JAX engine, the bidirectional recurrence runs over the whole canvas,
past a short row's ``kv_len``, so a hybrid's paged lanes decode other
tokens than its dense lanes.
"""
from __future__ import annotations

import dataclasses
import functools
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core import runtime
from repro_torch.core.cache import PagedCache, n_logical_pages
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm.decoding import (DecodeSettings,
                                      partial_prefill_supported)
from repro_torch.dlm.scheduler import UnmaskScheduler, resolve_scheduler
from repro_torch.dlm.session import DecodeSession, SharedPrefix
from repro_torch.serving.faults import FaultInjector, FaultPlan, choose_index
from repro_torch.serving.hier import (HostPageCorruption, HostPagePool,
                                      TierManager)
from repro_torch.serving.pool import OutOfPages, PagePool, cache_signature
from repro_torch.serving.prefix import PrefixIndex, PrefixMatch
from repro_torch.serving.slo import SLO, SLOPolicy
from repro_torch.serving.supervisor import EngineSupervisor, SupervisorConfig
from repro_torch.serving.telemetry import (PID_ENGINE, PID_EVENTS,
                                           PID_REQUESTS, Histogram, Telemetry)

# (settings, strategy, scheduler): one DecodeSession per distinct key.
LaneKey = Tuple[DecodeSettings, CacheStrategy, UnmaskScheduler]


@dataclasses.dataclass(frozen=True)
class RequestEvent:
    """One streaming event of a request.

    ``kind``: "token" (``positions`` / ``tokens`` carry the gen-span
    offsets and values committed since the last event), "done" (the output
    in ``tokens``), "shed" (the SLO policy or the degradation ladder
    dropped it), "aborted" (fault containment killed it) or "canceled".
    Delivered to ``Request.sink`` if set, else to the engine-level
    ``event_sink`` for ``stream=True`` requests, always on the engine
    thread (the front end moves them onto its event loop)."""
    kind: str
    uid: int
    step: int
    ts: float
    positions: Tuple[int, ...] = ()   # offsets into the gen span
    tokens: Tuple[int, ...] = ()


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [P] int32
    gen_len: int
    settings: Optional[DecodeSettings] = None
    strategy: Optional[CacheStrategy] = None
    scheduler: Optional[UnmaskScheduler] = None
    priority: int = 0               # higher preempts lower
    submitted_at: float = dataclasses.field(default_factory=time.time)
    started_at: Optional[float] = None   # first admission to a slot
    completed_at: Optional[float] = None
    output: Optional[np.ndarray] = None
    lane: Optional[LaneKey] = None  # resolved once at submit()
    # paged bookkeeping
    row_len: int = 0                # page-aligned prompt + gen span
    n_pages: int = 0                # composite pages needed
    pages: Optional[List[int]] = None
    # shared-prefix attachment: read holds on index pages mapped at logical
    # [0, shared_n); pages[:shared_n] is the copy-on-write reserve.  The
    # holds go at copy-on-write (or at harvest, preemption or cancel)
    holds: Optional[List[int]] = None
    shared_n: int = 0
    shared_full: bool = False       # the hit covers the whole row span
    plan_epoch: Optional[int] = None  # index epoch the plan was made at
    # host tier: a plan whose match lives (partly) in host RAM waits here
    # until the engine promotes it; no_promote (sticky) makes a request
    # whose promotion failed plan device-only
    pending_promotion: Optional[PrefixMatch] = None
    no_promote: bool = False
    preemptions: int = 0
    served_steps: int = 0           # per-request max_steps budget
    snapshot: Optional[Dict[str, np.ndarray]] = None  # preemption resume
    # online serving
    slo: Optional[SLO] = None       # TTFT target + e2e deadline
    stream: bool = False            # emit per-token events
    sink: Optional[Callable] = None  # per-request event callback
    canceled: bool = False          # set by cancel(); the loop reaps it
    shed: bool = False              # canceled BY the SLO policy
    first_token_at: Optional[float] = None
    last_commit_at: Optional[float] = None
    tokens_done: int = 0            # committed so far (TPOT denominator)
    # emitted mask [gen_len]: the gen-span offsets already streamed; it
    # survives preemption, so a resumed request never repeats or drops one
    emitted: Optional[np.ndarray] = None
    boosted: bool = False           # urgency transition already seen
    # fault containment: the fault class that aborted the request ("nan",
    # "pool_alloc"), and the bounded retry with backoff of transient
    # admission allocation failures
    fault: Optional[str] = None
    alloc_retries: int = 0
    retry_after_step: int = 0       # backoff gate on the step clock


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_committed: int = 0
    requests_done: int = 0
    swaps: int = 0                  # mid-loop slot replacements
    preemptions: int = 0            # running requests evicted for pages
    admission_stalls: int = 0       # admission attempts blocked on pages
    # shared-prefix index
    prefix_hits: int = 0            # admissions that attached index pages
    prefix_full_hits: int = 0       # ... covering the whole row span
    prefix_tokens_saved: int = 0    # canvas rows NOT prefilled
    prefix_published: int = 0       # pages copied into the index
    prefix_publish_skipped: int = 0  # publications dropped (pool short)
    prefix_evicted_pages: int = 0   # index pages evicted under pressure
    # host tier: evicted pages split into demoted and dropped
    prefix_demoted_pages: int = 0   # ... demoted to the host tier
    prefix_dropped_pages: int = 0   # ... dropped (tier off, full, stable)
    tier_dropped_full: int = 0      # demotions the host tier had no room for
    tier_dropped_stable: int = 0    # ... skipped as stable under pressure
    prefix_promoted_pages: int = 0  # host pages promoted back
    prefix_promotions: int = 0      # promotions served
    promotion_stalls: int = 0       # promotions abandoned (no headroom)
    peak_pool_util: float = 0.0
    steady_pool_util: float = 0.0
    peak_host_util: float = 0.0     # host-tier unit budget high-water
    # online serving / SLO accounting
    requests_shed: int = 0          # dropped by the SLO policy
    requests_canceled: int = 0      # client cancel / disconnect
    slo_met: int = 0                # completed within their SLO
    slo_missed: int = 0             # completed past TTFT/deadline, or shed
    # latency distributions are telemetry histograms: fixed buckets for
    # Prometheus, retained samples for exact percentiles; list-compatible
    e2e_latencies: Histogram = dataclasses.field(
        default_factory=functools.partial(
            Histogram, "spa_engine_e2e_latency_seconds",
            "request end-to-end latency (submit to harvest)"))
    queue_waits: Histogram = dataclasses.field(
        default_factory=functools.partial(
            Histogram, "spa_engine_queue_wait_seconds",
            "queue wait (submit to first admission)"))
    ttft_latencies: Histogram = dataclasses.field(
        default_factory=functools.partial(
            Histogram, "spa_engine_ttft_seconds",
            "time to first committed token"))
    tpot_latencies: Histogram = dataclasses.field(
        default_factory=functools.partial(
            Histogram, "spa_engine_tpot_seconds",
            "per-request time per output token"))
    # fault tolerance
    faults_injected: int = 0        # injector fires (replay fingerprint)
    requests_faulted: int = 0       # aborted by fault containment
    alloc_faults: int = 0           # transient admission alloc failures
    host_checksum_failures: int = 0  # promotions refused on a checksum
    host_corrupt_pages: int = 0     # ... and the corrupt pages they held
    tier_store_faults: int = 0      # demotion writes the tier refused
    cold_prefill_fallbacks: int = 0  # corrupted promotions served cold
    nan_quarantines: int = 0        # poisoned rows aborted by the guard
    disconnect_bursts: int = 0      # injected mass client hangups
    watchdog_fires: int = 0         # stuck lanes force-preempted
    invariant_checks: int = 0       # supervisor accounting audits run
    publish_paused_skips: int = 0   # publications skipped at ladder L1+
    degrade_level: int = 0          # current ladder rung (0 = full)
    degradations: int = 0           # upward ladder transitions
    restorations: int = 0           # downward ladder transitions
    degradation_events: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)       # (step, new level), both directions

    def tps(self, wall: float) -> float:
        return self.tokens_committed / max(wall, 1e-9)

    def goodput(self, wall: float) -> float:
        """Requests completed WITHIN their SLO per clock second (a request
        without an SLO counts as met when it completes; shed, canceled and
        late requests never count)."""
        return self.slo_met / max(wall, 1e-9)

    def percentiles(self) -> Dict[str, float]:
        """p50/p95 end-to-end, queue-wait, TTFT and TPOT (seconds), from
        :meth:`Histogram.percentile` (numpy's values on the samples)."""
        out: Dict[str, float] = {}
        for name, h in (("e2e", self.e2e_latencies),
                        ("wait", self.queue_waits),
                        ("ttft", self.ttft_latencies),
                        ("tpot", self.tpot_latencies)):
            out[f"{name}_p50"] = h.percentile(50)
            out[f"{name}_p95"] = h.percentile(95)
        return out


# EngineStats field -> Prometheus metric mirror (the JAX engine's table:
# spa_<subsystem>_<quantity>[_<unit>], monotonic counters end in _total).
_STATS_COUNTERS: Tuple[Tuple[str, str, str], ...] = (
    ("steps", "spa_engine_steps_total", "engine iterations"),
    ("tokens_committed", "spa_engine_tokens_committed_total",
     "tokens committed across all requests"),
    ("requests_done", "spa_engine_requests_done_total",
     "requests harvested with output"),
    ("swaps", "spa_engine_swaps_total", "mid-loop slot replacements"),
    ("preemptions", "spa_engine_preemptions_total",
     "running requests evicted for pages/priority"),
    ("admission_stalls", "spa_engine_admission_stalls_total",
     "admission attempts blocked on pages"),
    ("prefix_hits", "spa_prefix_hits_total",
     "admissions that attached index pages"),
    ("prefix_full_hits", "spa_prefix_full_hits_total",
     "prefix hits covering the whole row span"),
    ("prefix_tokens_saved", "spa_prefix_tokens_saved_total",
     "prompt+canvas rows not re-prefilled"),
    ("prefix_published", "spa_prefix_published_pages_total",
     "pages copied into the index"),
    ("prefix_publish_skipped", "spa_prefix_publish_skipped_total",
     "publications dropped (pool short)"),
    ("prefix_evicted_pages", "spa_prefix_evicted_pages_total",
     "index pages evicted under pressure"),
    ("prefix_demoted_pages", "spa_tier_demoted_pages_total",
     "evicted pages demoted to the host tier"),
    ("prefix_dropped_pages", "spa_tier_dropped_pages_total",
     "evicted pages dropped outright"),
    ("prefix_promoted_pages", "spa_tier_promoted_pages_total",
     "host pages promoted back to device"),
    ("prefix_promotions", "spa_tier_promotions_total",
     "promotion events serviced"),
    ("promotion_stalls", "spa_tier_promotion_stalls_total",
     "promotions abandoned (no headroom)"),
    ("requests_shed", "spa_slo_requests_shed_total",
     "requests dropped by the SLO policy / ladder"),
    ("requests_canceled", "spa_engine_requests_canceled_total",
     "client cancels / disconnects"),
    ("slo_met", "spa_slo_met_total", "completions within SLO"),
    ("slo_missed", "spa_slo_missed_total",
     "completions past TTFT/deadline (incl. shed)"),
    ("requests_faulted", "spa_fault_requests_faulted_total",
     "requests aborted by fault containment"),
    ("alloc_faults", "spa_fault_alloc_failures_total",
     "transient admission alloc failures"),
    ("host_checksum_failures", "spa_fault_host_checksum_failures_total",
     "corrupt host pages caught at promotion"),
    ("cold_prefill_fallbacks", "spa_fault_cold_prefill_fallbacks_total",
     "corrupted promotions served by cold prefill"),
    ("nan_quarantines", "spa_fault_nan_quarantines_total",
     "poisoned rows aborted by the NaN guard"),
    ("disconnect_bursts", "spa_fault_disconnect_bursts_total",
     "injected mass client hangups"),
    ("watchdog_fires", "spa_fault_watchdog_fires_total",
     "stuck lanes force-preempted"),
    ("invariant_checks", "spa_fault_invariant_checks_total",
     "supervisor accounting audits run"),
    ("publish_paused_skips", "spa_fault_publish_paused_skips_total",
     "publications skipped at ladder L1+"),
    ("degradations", "spa_fault_degradations_total",
     "upward ladder transitions"),
    ("restorations", "spa_fault_restorations_total",
     "downward ladder transitions"),
)

_RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                  1.0, 1.5, 2.0, 4.0)
_DRIFT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3,
                  0.6, 1.0, 1.5, 2.0)
_HIT_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 canvas_len: int = 64,
                 settings: Optional[DecodeSettings] = None,
                 strategy: Optional[CacheStrategy] = None,
                 scheduler: Optional[UnmaskScheduler] = None,
                 continuous: bool = True,
                 pool_pages: int = 0, page_size: int = 16,
                 prefix_cache: bool = False,
                 host_pages: int = 0, host_dtype: str = "auto",
                 slo_policy: Optional[SLOPolicy] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 supervise: bool = False,
                 supervisor_cfg: Optional[SupervisorConfig] = None,
                 telemetry: Optional[Telemetry] = None,
                 profiler=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_device(params["embed"], self.device, "params")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.canvas_len = canvas_len
        self.settings = settings or DecodeSettings()
        self.strategy = resolve_strategy(cfg, strategy)
        self.scheduler = scheduler    # None -> derived from settings
        self.continuous = continuous
        self.paged = pool_pages > 0
        self.page_size = page_size
        self.pool: Optional[PagePool] = None
        self.prefix: Optional[PrefixIndex] = None
        if self.paged:
            n_logical_pages(canvas_len, page_size)  # divisibility check
            self.pool = PagePool(cfg, n_pages=pool_pages,
                                 page_size=page_size,
                                 strategy=self.strategy, device=self.device)
            if prefix_cache:
                self.prefix = PrefixIndex(page_size)
        # host-RAM page tier: evicted index entries demote host-ward
        self.host_pool: Optional[HostPagePool] = None
        self.tier: Optional[TierManager] = None
        if self.prefix is not None and host_pages > 0:
            self.host_pool = HostPagePool(host_pages, device=self.device)
            self.tier = TierManager(self.host_pool, host_dtype=host_dtype,
                                    read_pages=self._tier_read,
                                    device=self.device)
            self.prefix.tier = self.tier
        # partial (suffix-only) reuse needs a window-free all-attention
        # stack and a float cache; full hits are a page copy
        self._partial_ok = (partial_prefill_supported(cfg)
                            and cfg.cache_dtype != "int8")
        self._prefix_epoch = 0        # bumps on every index mutation
        self.queue: deque[Request] = deque()
        self.done: List[Request] = []
        self.stats = EngineStats()
        self._clock = clock or time.time
        self._wall = 0.0
        self._next_uid = 0            # monotonic: uids never recycle
        # admission re-scan gate: set by submit() and by anything that
        # frees a slot or pages, cleared after each admission attempt
        self._admission_dirty = True
        self._sessions: Dict[LaneKey, DecodeSession] = {}
        # offline proxy artefacts are per STRATEGY, shared across lanes
        self._proxies: Dict[CacheStrategy, object] = {}
        self._running: Dict[int, Request] = {}   # uid -> in-flight
        # online serving
        self.slo_policy = slo_policy
        # telemetry: the registry always exists (render_metrics reads live
        # state through a collector); the tracer is off by default and is
        # stamped from the engine clock, so a virtual-clock run's trace is
        # the same on every machine
        self.telemetry = telemetry or Telemetry.disabled()
        self.telemetry.tracer.clock = self._clock
        self._tr = self.telemetry.tracer
        self.telemetry.registry.add_collector(self._collect_metrics)
        # step-time decomposition: a StepProfiler handed to every lane
        # session, or None (the unprofiled path)
        self.profiler = profiler
        self._lane_ids: Dict[LaneKey, int] = {}
        self.event_sink: Optional[Callable[[RequestEvent], None]] = None
        # thread-safe intake: closures put by submit_threadsafe /
        # cancel_threadsafe, drained on the engine thread at the overlap
        # point (and while idle in run_online)
        self._mailbox: "queue_mod.Queue[Callable[[], None]]" = \
            queue_mod.Queue()
        self._uid_lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        # fault tolerance: a seeded injector probed at the seams, and a
        # supervisor around the step loop.  A plan without a supervisor
        # would hang on a lane stall, so injection implies supervision
        self.faults: Optional[FaultInjector] = None
        if fault_plan is not None:
            self.faults = FaultInjector(fault_plan)
            if self.pool is not None:
                self.pool.fault_hook = self.faults
            if self.tier is not None:
                self.tier.injector = self.faults
            # every fire becomes a trace instant with the log's schema
            self.faults.on_fire = self._trace_fault
        # the degradation ladder's flags, set by the supervisor
        self._publish_paused = False
        self._host_tier_paused = False
        self._shed_low_priority = False
        self._shed_below = 0
        self._hopeless_margin = 0.0
        self.supervisor: Optional[EngineSupervisor] = None
        if supervise or supervisor_cfg is not None or fault_plan is not None:
            EngineSupervisor(self, supervisor_cfg)   # attaches itself

    def _now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------

    def _trace_fault(self, site: str, probe: int) -> None:
        """An injector fire as a trace instant, with the schema of the
        ``FaultInjector.log`` entry ``(site, probe)``."""
        self._tr.instant(PID_EVENTS, 1, f"fault:{site}", cat="fault",
                         args={"site": site, "probe": probe,
                               "step": self.stats.steps})

    def _lane_id(self, lane: LaneKey) -> int:
        lid = self._lane_ids.get(lane)
        if lid is None:
            lid = self._lane_ids[lane] = len(self._lane_ids)
            self._tr.name_track(PID_ENGINE, lid, f"lane{lid}")
        return lid

    def _phase_end(self, lid: int, name: str) -> None:
        """Close an engine-phase span and fold its duration into the
        step-time breakdown histogram."""
        tr = self._tr
        tr.end(PID_ENGINE, lid, name)
        self.telemetry.registry.histogram(
            "spa_engine_phase_seconds",
            "per-iteration step-time breakdown",
            labels={"phase": name}).observe(tr.events[-1].dur)

    def _note_cache_dynamics(self, sess: DecodeSession,
                             strategy: CacheStrategy, n_live: int) -> None:
        """Fold one ``DecodeSession.cache_dynamics()`` probe into the
        registry: per-layer refresh-budget utilization, proxy drift and
        selection overlap.  Host-side, after the step's first host sync."""
        dyn = sess.cache_dynamics()
        if dyn is None:
            return
        reg = self.telemetry.registry
        if dyn["refreshed"]:
            # a full refresh rewrites every row: utilization and drift
            # describe the incremental selection, so only count the event
            reg.counter("spa_cache_refresh_steps_total",
                        "steps that ran a full cache refresh").inc()
            return
        try:
            ks = strategy.k_schedule(self.cfg, self.canvas_len)
        except (NotImplementedError, AttributeError):
            ks = None
        for kind, layers in dyn["kinds"].items():
            for layer, d in enumerate(layers):
                labels = {"kind": kind, "layer": str(layer)}
                if ks is not None and layer < len(ks) and n_live:
                    util = d["changed"] / max(int(ks[layer]) * n_live, 1)
                    reg.histogram(
                        "spa_cache_budget_utilization_ratio",
                        "refreshed rows / (k_schedule budget * live "
                        "rows) per step", labels=labels,
                        buckets=_RATIO_BUCKETS).observe(util)
                if d["drift"]:
                    h = reg.histogram(
                        "spa_cache_proxy_drift",
                        "1 - cos(prev proxy row, new proxy row) over "
                        "refreshed rows", labels=labels,
                        buckets=_DRIFT_BUCKETS)
                    for x in d["drift"]:
                        h.observe(x)
                if d["overlap"] is not None:
                    reg.histogram(
                        "spa_cache_selection_overlap_ratio",
                        "Jaccard overlap of consecutive refreshed-row "
                        "sets", labels=labels,
                        buckets=_RATIO_BUCKETS).observe(d["overlap"])

    def _collect_metrics(self) -> None:
        """Registry collector: mirror live engine state (EngineStats
        counters, pool and tier occupancy, queue depth, the trace tracker's
        ``spa_runtime_*`` series) into the registry right before every
        render() / snapshot()."""
        reg, s = self.telemetry.registry, self.stats
        for field, metric, help_txt in _STATS_COUNTERS:
            reg.counter(metric, help_txt).set(getattr(s, field))
        if self.faults is not None:
            reg.counter("spa_fault_injected_total",
                        "fault-injector fires").set(self.faults.total_fired)
        reg.gauge("spa_fault_degrade_level",
                  "graceful-degradation ladder rung (0 = full service)"
                  ).set(s.degrade_level)
        reg.gauge("spa_engine_queue_depth",
                  "queued requests").set(len(self.queue))
        reg.gauge("spa_engine_running_requests",
                  "admitted in-flight requests").set(len(self._running))
        for h, name in ((s.e2e_latencies, "spa_engine_e2e_latency_seconds"),
                        (s.queue_waits, "spa_engine_queue_wait_seconds"),
                        (s.ttft_latencies, "spa_engine_ttft_seconds"),
                        (s.tpot_latencies, "spa_engine_tpot_seconds")):
            # re-adopt on every collect: `eng.stats = EngineStats()`
            # resets swap the histogram objects
            reg.adopt(h, name, h.help)
        for obj in (self.pool, self.prefix, self.host_pool):
            if obj is not None:
                for name, (help_txt, val) in obj.telemetry_gauges().items():
                    reg.gauge(name, help_txt).set(val)
        # trace accounting and the live-executable count (core/runtime.py)
        runtime.compile_tracker().export_metrics(reg)
        if self.pool is not None:
            for sig, nbytes in self.pool.arena_bytes().items():
                reg.gauge("spa_pool_arena_bytes",
                          "device bytes per cache-signature arena",
                          labels={"signature": sig}).set(nbytes)

    def render_metrics(self) -> str:
        """Prometheus text exposition of the live registry (the front end's
        ``GET /metrics``).  Reads race the engine thread benignly: ints and
        floats only."""
        return self.telemetry.registry.render()

    def export_trace(self, path: str) -> None:
        """Write the tracer's Chrome trace JSON (loads in Perfetto)."""
        self._tr.export(path)

    def request_states(self, done_tail: int = 32) -> Dict[str, List[Dict]]:
        """JSON-able per-request lifecycle view (``GET /debug/requests``):
        queued, running and recently finished, with timings."""
        def row(r: Request, state: str) -> Dict:
            return {
                "uid": r.uid, "state": state, "priority": r.priority,
                "gen_len": r.gen_len, "pages": r.n_pages,
                "shared_pages": r.shared_n,
                "preemptions": r.preemptions,
                "tokens_done": r.tokens_done,
                "submitted_at": r.submitted_at,
                "started_at": r.started_at,
                "first_token_at": r.first_token_at,
                "completed_at": r.completed_at,
                "shed": r.shed, "canceled": r.canceled,
                "fault": r.fault,
                "slo": (None if r.slo is None else
                        {"ttft": (None if r.slo.ttft == float("inf")
                                  else r.slo.ttft),
                         "deadline": (None
                                      if r.slo.deadline == float("inf")
                                      else r.slo.deadline)}),
            }
        return {
            "queued": [row(r, "queued") for r in list(self.queue)],
            "running": [row(r, "running")
                        for r in list(self._running.values())],
            "done": [row(r, "done") for r in self.done[-done_tail:]],
        }

    def pool_debug_state(self) -> Dict:
        """JSON-able memory view (``GET /debug/pool``): device-pool
        occupancy, fragmentation and per-signature bytes, host-tier slot
        accounting, the tier's page counts (refused stores included) and the
        live-executable count (loaded kernel libraries and CUDA graphs), the
        JAX engine's keys.  The tier's counts are the tier manager's
        lifetime tallies, and the host pool's pages in / out run from its
        last ``reset_telemetry``, as in the JAX engine: resetting
        :class:`EngineStats` leaves both.  Reads race the engine thread
        benignly."""
        out: Dict = {"paged": self.paged,
                     "live_executables": runtime.live_executable_count()}
        if self.pool is not None:
            out["pool"] = self.pool.debug_state()
        if self.host_pool is not None:
            out["host_pool"] = self.host_pool.debug_state()
        if self.tier is not None:
            t = self.tier
            out["tier"] = {
                "demoted_pages": t.demoted_pages,
                "promoted_pages": t.promoted_pages,
                "dropped_full": t.dropped_full,
                "dropped_stable": t.dropped_stable,
                "store_faults": t.store_faults,
                "checksum_failures": t.checksum_failures,
            }
        return out

    # ------------------------------------------------------------------
    # Intake
    # ------------------------------------------------------------------

    def submit(self, prompt: np.ndarray, gen_len: int,
               settings: Optional[DecodeSettings] = None,
               strategy: Optional[CacheStrategy] = None,
               scheduler: Optional[UnmaskScheduler] = None,
               priority: int = 0,
               row_len: Optional[int] = None,
               slo: Optional[SLO] = None,
               stream: bool = False,
               sink: Optional[Callable] = None) -> int:
        """Queue one request.  Rejects requests that can never be
        scheduled (``gen_len`` outside the canvas, or more pages than the
        whole pool) instead of letting them starve the queue.  ``row_len``
        (paged mode) reserves a larger page-aligned canvas span than
        prompt + gen needs.  ``slo`` / ``stream`` / ``sink`` are the online
        surface.  Engine thread only: other threads use
        ``submit_threadsafe``."""
        req = self._build_request(prompt, gen_len, settings, strategy,
                                  scheduler, priority=priority,
                                  row_len=row_len, slo=slo, stream=stream,
                                  sink=sink)
        self._enqueue(req)
        return req.uid

    def submit_threadsafe(self, prompt: np.ndarray, gen_len: int,
                          **kw) -> int:
        """``submit`` from any thread: validation and lane resolution run
        on the caller (errors raise there), the queue append rides the
        mailbox onto the engine thread.  Returns the uid at once; the
        request's ``sink`` is attached before the engine can see it."""
        req = self._build_request(prompt, gen_len, **kw)
        self._mailbox.put(lambda: self._enqueue(req))
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Abort a queued or running request: its pages and canvas row are
        released and it finalizes with no output (a "canceled" event).
        Engine thread only: other threads use ``cancel_threadsafe``.
        Returns False for unknown or finished uids."""
        for r in list(self.queue):
            if r.uid == uid:
                self.queue.remove(r)
                self._drop_plan(r)
                r.canceled = True
                self._finalize_aborted(r)
                return True
        r = self._running.get(uid)
        if r is not None and not r.canceled:
            r.canceled = True     # the step loop releases slot + pages
            return True
        return False

    def cancel_threadsafe(self, uid: int) -> None:
        self._mailbox.put(lambda: self.cancel(uid))

    def _enqueue(self, req: Request) -> None:
        self._admission_dirty = True
        self.queue.append(req)
        tr = self._tr
        if tr.enabled:
            tr.name_track(PID_REQUESTS, req.uid, f"req {req.uid}")
            tr.begin(PID_REQUESTS, req.uid, "request", cat="lifecycle",
                     args={"prompt_len": int(len(req.prompt)),
                           "gen_len": req.gen_len,
                           "priority": req.priority})
            tr.begin(PID_REQUESTS, req.uid, "queued", cat="lifecycle")

    def _drain_mailbox(self) -> None:
        while True:
            try:
                fn = self._mailbox.get_nowait()
            except queue_mod.Empty:
                return
            fn()

    def _build_request(self, prompt: np.ndarray, gen_len: int,
                       settings: Optional[DecodeSettings] = None,
                       strategy: Optional[CacheStrategy] = None,
                       scheduler: Optional[UnmaskScheduler] = None,
                       priority: int = 0,
                       row_len: Optional[int] = None,
                       slo: Optional[SLO] = None,
                       stream: bool = False,
                       sink: Optional[Callable] = None) -> Request:
        # all validation runs here, on the submitting thread, so an invalid
        # request raises at the caller and never inside the engine loop
        if not isinstance(gen_len, (int, np.integer)) \
                or isinstance(gen_len, bool):
            raise ValueError(f"gen_len must be an int, got "
                             f"{type(gen_len).__name__}")
        if gen_len <= 0 or gen_len > self.canvas_len:
            raise ValueError(
                f"gen_len {gen_len} cannot be scheduled on a "
                f"canvas_len={self.canvas_len} engine (need "
                f"0 < gen_len <= canvas_len)")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be a 1-D token array, got "
                             f"shape {prompt.shape}")
        if prompt.size and not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got "
                             f"dtype {prompt.dtype}")
        with self._uid_lock:          # submit_threadsafe callers race
            uid = self._next_uid
            self._next_uid += 1
        req = Request(uid, prompt.astype(np.int32), gen_len, settings,
                      strategy, scheduler, priority=priority,
                      submitted_at=self._now(), slo=slo, stream=stream,
                      sink=sink)
        req.lane = self._lane_of(req)   # freeze vs later default changes
        if self.paged:
            p_len = min(len(req.prompt), self.canvas_len - gen_len)
            span = max(p_len + gen_len, row_len or 0)
            req.row_len = min(-(-span // self.page_size) * self.page_size,
                              self.canvas_len)
            req.n_pages = (self.pool.pages_for(req.row_len)
                           if req.lane[1].uses_cache else 0)
            if req.n_pages > self.pool.capacity:
                raise OutOfPages(
                    f"request uid={uid} needs {req.n_pages} pages; pool "
                    f"capacity is {self.pool.capacity}: it can never be "
                    f"admitted (grow --pool-pages or shrink the request)")
        else:
            req.row_len = self.canvas_len
        return req

    # ------------------------------------------------------------------
    # Online serving: events, SLO shedding, cancellation
    # ------------------------------------------------------------------

    def _emit(self, req: Request, kind: str,
              positions: Tuple[int, ...] = (),
              tokens: Tuple[int, ...] = ()) -> None:
        sink = req.sink or (self.event_sink if req.stream else None)
        if sink is None:
            return
        sink(RequestEvent(kind=kind, uid=req.uid, step=self.stats.steps,
                          ts=self._now(), positions=positions,
                          tokens=tokens))

    def _eff_priority(self, req: Request, now: float) -> int:
        if self.slo_policy is None:
            return req.priority
        return self.slo_policy.effective_priority(req, now)

    def _shed_hopeless(self) -> None:
        """Drop queued requests that can no longer contribute goodput
        (TTFT missed while waiting, or the e2e deadline passed).  At ladder
        L3 low-priority queued work is shed outright and the SLO deadlines
        tighten by ``hopeless_margin``."""
        if self._shed_low_priority:
            for r in list(self.queue):
                if r.priority < self._shed_below:
                    self.queue.remove(r)
                    self._drop_plan(r)
                    r.shed = True
                    self._finalize_aborted(r)
        if self.slo_policy is None or not self.slo_policy.shed:
            return
        now = self._now()
        for r in list(self.queue):
            if r.slo is not None and self.slo_policy.hopeless(
                    r, now, margin=self._hopeless_margin):
                self.queue.remove(r)
                self._drop_plan(r)
                r.shed = True
                self._finalize_aborted(r)

    def _finalize_aborted(self, req: Request) -> None:
        """The exit of canceled, shed and faulted requests: release every
        resource (a queued request's read holds were dropped by the caller;
        a running one still owns pages) and finalize with no output."""
        if self.paged:
            self._release_holds(req)
            if req.pages:
                self.pool.free(req.pages)
                req.pages = None
        req.completed_at = self._now()
        self._running.pop(req.uid, None)
        self._admission_dirty = True   # a slot/pages may have freed
        self.done.append(req)
        if self._tr.enabled:
            # the request may be mid-"queued" or mid-"running": close
            # whatever is open on its track so no span is left open
            outcome = ("shed" if req.shed
                       else "fault" if req.fault is not None
                       else "canceled")
            self._tr.close_track(PID_REQUESTS, req.uid,
                                 args={"outcome": outcome})
        if req.shed:
            self.stats.requests_shed += 1
            if req.slo is not None:   # a shed request IS a missed SLO
                self.stats.slo_missed += 1
            self._emit(req, "shed")
        elif req.fault is not None:
            self.stats.requests_faulted += 1
            self._emit(req, "aborted")
        else:
            self.stats.requests_canceled += 1
            self._emit(req, "canceled")

    def _host_overlap(self, lane: LaneKey,
                      slots: List[Optional[Request]]) -> None:
        """Host work while the step just launched runs on the card: it runs
        before the first host sync on the step's outputs.  Mailbox intake,
        SLO shedding, and the prefix plan (read holds, and a promotion
        queued behind the step) of the next admission candidate, which
        ``_admit_one`` reuses through ``plan_epoch``."""
        self._drain_mailbox()
        self._shed_hopeless()
        pol = self.slo_policy
        if pol is not None and self.queue and not self._admission_dirty:
            # a queued request crossing the urgency threshold changes the
            # admission outcome (its boost may preempt a running row)
            now = self._now()
            for r in self.queue:
                if not r.boosted and pol.urgent(r, now):
                    r.boosted = True
                    self._admission_dirty = True
        if pol is not None and pol.shed:
            now = self._now()
            for s in slots:
                if (s is not None and not s.canceled and s.slo is not None
                        and now > s.submitted_at + s.slo.deadline):
                    s.canceled = True    # running past its deadline: shed
                    s.shed = True
        if self._stop is not None and self._stop.is_set():
            for s in slots:              # clean shutdown: abort in-flight
                if s is not None:
                    s.canceled = True
        if self.prefix is not None and self._admission_dirty:
            for req in self._lane_candidates(lane)[:1]:
                if req.n_pages:
                    self._plan(req)

    def _stream_tokens(self, slots: List[Optional[Request]],
                       sess: DecodeSession, p_lens: List[int]) -> None:
        """Token events of streaming slots: diff each row's gen span of the
        canvas against its request's emitted mask (the canvas, not the
        commit ring, so wide commits that overflow the ring drop nothing).
        Costs one host copy of the canvas a step while any row streams."""
        live = [(i, s) for i, s in enumerate(slots)
                if s is not None and not s.canceled and s.fault is None
                and (s.sink is not None
                     or (s.stream and self.event_sink is not None))]
        if not live:
            return
        toks = sess.host_tokens()
        mask_id = self.cfg.mask_id
        for i, req in live:
            span = toks[i, p_lens[i]: p_lens[i] + req.gen_len]
            if req.emitted is None:
                req.emitted = np.zeros((req.gen_len,), bool)
            fresh = (span != mask_id) & ~req.emitted
            if not fresh.any():
                continue
            pos = np.nonzero(fresh)[0]
            req.emitted[pos] = True
            self._emit(req, "token", positions=tuple(int(p) for p in pos),
                       tokens=tuple(int(t) for t in span[pos]))

    # ------------------------------------------------------------------
    # Lanes
    # ------------------------------------------------------------------

    def _lane_of(self, req: Request) -> LaneKey:
        """Per-request overrides win wholesale, engine defaults fill the
        gaps; the legacy parallel knobs are normalized out of the keyed
        settings once the scheduler is resolved."""
        settings = req.settings or self.settings
        strategy = req.strategy or self.strategy
        if req.scheduler is not None:
            scheduler = req.scheduler
        elif req.settings is not None:
            scheduler = resolve_scheduler(req.settings)
        else:
            scheduler = resolve_scheduler(self.settings, self.scheduler)
        settings = dataclasses.replace(settings, parallel_threshold=0.0,
                                       max_parallel=0)
        return settings, strategy, scheduler

    def _proxies_for(self, strategy: CacheStrategy):
        if strategy not in self._proxies:
            self._proxies[strategy] = strategy.build_proxies(
                self.params, self.cfg)
        return self._proxies[strategy]

    def _session_for(self, lane: LaneKey) -> DecodeSession:
        if lane not in self._sessions:
            settings, strategy, scheduler = lane
            # lane tracks numbered as sessions; the label is the JAX one
            label = (f"{strategy.name}/{strategy.backend.name}"
                     f"/{type(scheduler).__name__}#{self._lane_id(lane)}")
            self._sessions[lane] = DecodeSession(
                self.params, self.cfg, strategy=strategy,
                settings=settings, scheduler=scheduler,
                spa_proxies=self._proxies_for(strategy),
                device=self.device, profiler=self.profiler, label=label)
        return self._sessions[lane]

    def _lane_candidates(self, lane: LaneKey) -> List[Request]:
        """Lane-matching queued requests in admission order: strict
        (effective) priority first; within a priority, queue order, or
        under an SLO policy the earliest TTFT deadline first (EDF) with
        queue order breaking ties.  The SLO boost folds into the effective
        priority, so a near-deadline request jumps ahead of (and may
        preempt) slack-rich peers."""
        matches = [(i, r) for i, r in enumerate(self.queue)
                   if r.lane == lane]
        if self.slo_policy is None:
            return [r for _, r in sorted(
                matches, key=lambda ir: (-ir[1].priority, ir[0]))]
        pol, now = self.slo_policy, self._now()
        return [r for _, r in sorted(matches, key=lambda ir: (
            -pol.effective_priority(ir[1], now),
            pol.ttft_slack(ir[1], now), ir[0]))]

    # ------------------------------------------------------------------
    # Shared-prefix index
    # ------------------------------------------------------------------

    def _prompt_in_canvas(self, req: Request) -> np.ndarray:
        """The prompt tokens that land on the canvas (the index key
        describes the canvas, not the raw request)."""
        return req.prompt[: self.canvas_len - req.gen_len]

    def _prefix_key(self, req: Request):
        return (req.row_len, req.lane[1].prefix_key())

    def _prefix_plan(self, req: Request) -> None:
        """Consult the index for an admission candidate: on a hit, take read
        holds on the matched pages, to be mapped at the row's logical
        prefix with ``req.pages[:shared_n]`` as the copy-on-write reserve.
        Runs BEFORE the shortage check, so the holds protect the matched
        entry from this admission's own index eviction; a stalled candidate
        releases them again.  Resumed requests never match: their canvas
        holds committed tokens the publisher prefilled as [MASK]."""
        self._drop_plan(req)    # releases stale holds, never leaks them
        if (self.prefix is None or req.preemptions > 0
                or not req.n_pages):
            return
        match = self.prefix.lookup(
            self._prefix_key(req), self._prompt_in_canvas(req),
            partial_ok=self._partial_ok,
            promote_ok=(self.tier is not None and not req.no_promote
                        and not self._host_tier_paused))
        if match is None:
            return
        if match.needs_promotion:
            # no holds yet: _promote_now turns this into a device plan
            req.pending_promotion = match
            return
        self.pool.retain(list(match.pages))
        req.holds = list(match.pages)
        req.shared_n = match.n_pages
        req.shared_full = match.full

    def _plan(self, req: Request) -> None:
        """Plan ``req`` unless its plan was made at the current index epoch
        (the plan made while the last step ran on the card), and promote a
        plan that waits on the host tier.  A failed promotion plans again
        once; a second failure gives up on the tier for this admission
        (``no_promote`` is sticky, so this ends) and plans device-only."""
        if req.plan_epoch != self._prefix_epoch:
            self._prefix_plan(req)
            req.plan_epoch = self._prefix_epoch
        if req.pending_promotion is None:
            return
        if not self._promote_now(req) and req.plan_epoch is None:
            self._prefix_plan(req)
            req.plan_epoch = self._prefix_epoch
            if (req.pending_promotion is not None
                    and not self._promote_now(req)):
                req.no_promote = True
                self._prefix_plan(req)
                req.plan_epoch = self._prefix_epoch

    def _drop_plan(self, req: Request) -> None:
        self._release_holds(req)
        req.shared_n, req.shared_full = 0, False
        req.plan_epoch = None
        req.pending_promotion = None

    def _release_holds(self, req: Request) -> None:
        if req.holds:
            self.pool.release(req.holds)
            req.holds = None

    def _count_prefix_hit(self, req: Request) -> None:
        """Admission succeeded: count the planned hit."""
        self.telemetry.registry.histogram(
            "spa_prefix_hit_depth_pages",
            "index pages attached per admission (0 = miss)",
            buckets=_HIT_DEPTH_BUCKETS).observe(req.shared_n
                                                if req.holds else 0)
        if not req.holds:
            return
        self.stats.prefix_hits += 1
        if req.shared_full:
            self.stats.prefix_full_hits += 1
            self.stats.prefix_tokens_saved += req.row_len
        else:
            self.stats.prefix_tokens_saved += req.shared_n * self.page_size

    def _attach_spec(self, req: Request, row: int):
        """(page-table row, SharedPrefix or None) for one slot."""
        if not req.holds:
            return self._pt_row(req), None
        m = req.shared_n
        spec = SharedPrefix(row=row, pages=tuple(req.holds),
                            reserve=tuple(req.pages[:m]))
        return (self.pool.page_table_row(req.holds + req.pages[m:],
                                         self.canvas_len), spec)

    def _on_cow(self, slots: List[Optional[Request]], specs) -> None:
        """The session copied shared pages on write: drop the read holds,
        the rows now run on their own pages."""
        for s in specs:
            req = slots[s.row]
            if req is not None:
                self._release_holds(req)

    def _maybe_publish(self, req: Request, sess: DecodeSession) -> None:
        """Publish an attached request's prefill-time pages into the index,
        at admission, before the first step writes them (harvest-time
        states would break the bit-exactness of full hits).  A cold
        request publishes its whole run (prompt path + all-[MASK] tail), a
        partial hit only the depths past its match.  A page copy pays for
        it; skipped when the pool has no slack."""
        if self.prefix is None or req.preemptions > 0 or not req.n_pages:
            return
        if not sess.state.cache.arenas:
            # a stack without attention layers (all RG-LRU) caches nothing,
            # so it has no pages to share (the JAX engine fails its copy)
            return
        if self._publish_paused:
            # ladder L1: stop growing shared state under fault pressure
            # (a miss costs prefill work, never correctness)
            self.stats.publish_paused_skips += 1
            return
        n_run = req.row_len // self.page_size
        m = req.shared_n if req.holds else 0
        if m >= n_run:
            return                       # full hit: already indexed
        key = self._prefix_key(req)
        prompt = self._prompt_in_canvas(req)
        # duplicate prompts admitted together all plan before the first
        # publishes: copy only the depths the index would adopt
        missing = [d for d in self.prefix.missing_slots(key, prompt, n_run)
                   if d >= m]
        if not missing:
            return
        pub = self.pool.alloc(len(missing))
        if pub is None:
            self.stats.prefix_publish_skipped += 1
            return
        sess.copy_cache_pages([req.pages[d] for d in missing], pub)
        pages: List[Optional[int]] = [None] * n_run
        for d, p in zip(missing, pub):
            pages[d] = p
        rejected = self.prefix.insert(key, prompt, pages)
        if rejected:
            self.pool.release(rejected)
        adopted = [p for p in pub if p not in rejected]
        if adopted and self.tier is not None:
            # the signature a later demotion reads, and each page's
            # stability from the identifier rows just copied
            self.tier.note_published(cache_signature(self.cfg, req.lane[1]),
                                     adopted, self._proxy_blocks(sess,
                                                                 adopted))
        self.stats.prefix_published += len(pub) - len(rejected)
        self._prefix_epoch += 1       # planned misses may now hit

    def drop_prefix_cache(self) -> int:
        """Release every index hold, free every host-tier ref and clear the
        trie.  Returns the device pages released."""
        if self.prefix is None:
            return 0
        self._prefix_epoch += 1
        return self.prefix.clear(self.pool)

    def _evict_index(self, n_pages: int) -> int:
        """Index eviction; the evicted pages split into demoted and dropped
        (as the index reports them).  Every ``host_store`` fire is one
        store the tier refused."""
        stores = self.faults.fired["host_store"] if self.faults else 0
        freed, demoted, dropped, full, stable = self.prefix.evict(
            self.pool, n_pages)
        if self.faults is not None:
            self.stats.tier_store_faults += (self.faults.fired["host_store"]
                                             - stores)
        self.stats.prefix_demoted_pages += demoted
        self.stats.prefix_dropped_pages += dropped
        self.stats.tier_dropped_full += full
        self.stats.tier_dropped_stable += stable
        if freed:
            self.stats.prefix_evicted_pages += freed
            self._prefix_epoch += 1
            self._tr.instant(
                PID_EVENTS, 2, "demote", cat="tier",
                args={"freed": freed, "step": self.stats.steps,
                      "demoted": demoted, "dropped": dropped})
        return freed

    # ------------------------------------------------------------------
    # Host tier: demotion and promotion IO
    # ------------------------------------------------------------------

    def _arenas_of(self, sig: Tuple):
        arenas = self.pool.peek_arenas(sig)
        assert arenas is not None, f"no arenas for signature {sig}"
        return arenas

    def _tier_read(self, sig: Tuple, pages: List[int]):
        """Demotion read: whole physical pages as device blocks.  A running
        lane's session holds these same arena tensors and writes them in
        place, so the gather is queued on the stream behind the step in
        flight (the one that last wrote the pages) and sees its values."""
        return cache_lib.read_arena_pages(self._arenas_of(sig), pages)

    def _tier_write(self, sig: Tuple, pages: List[int], blocks) -> None:
        """Promotion write: scatter the blocks into the signature's arenas
        (the tensors a running lane's session reads).  Queued on the stream
        without a host sync, after the host-to-device copies that produced
        the blocks and before the next step, which is the first to read the
        pages."""
        cache_lib.write_arena_pages(self._arenas_of(sig), pages, blocks)

    def _proxy_blocks(self, sess: DecodeSession, pages: List[int]):
        """Per-page identifier rows (the first layer kind that has them) for
        the tier's stability scores; None for proxy-less caches."""
        for kind, bufs in sess.state.cache.arenas.items():
            if "proxy" in bufs:
                blk = cache_lib.read_arena_pages({kind: {"proxy": bufs[
                    "proxy"]}}, pages)[kind]["proxy"]
                return {p: blk[:, i] for i, p in enumerate(pages)}
        return None

    def _promote_now(self, req: Request) -> bool:
        """Promote a plan that waits on the host tier: allocate device pages
        for the match's host refs, write the blocks into the arenas, point
        the trie at them and leave the request a device plan with read
        holds.  On failure the plan is dropped: a stale match plans again;
        no headroom marks the request ``no_promote``; a corrupt page scrubs
        the entry and the request is served cold."""
        match = req.pending_promotion
        req.pending_promotion = None
        if match is None:
            return False
        if not self.prefix.sites_intact(match):
            req.plan_epoch = None       # the trie moved: plan again
            return False
        n = len(match.host_refs)
        # hold the match's device prefix while making headroom, so this
        # eviction cannot take it
        self.pool.retain(list(match.pages))
        short = max(0, n - self.pool.available)
        if short and self.prefix.evictable_total(self.pool) >= short:
            self._evict_index(short)
        pages = self.pool.alloc(n)
        if pages is None or not self.prefix.sites_intact(match):
            if pages is not None:
                self.pool.free(pages)
            else:
                req.no_promote = True
            self.pool.release(list(match.pages))
            req.plan_epoch = None
            self.stats.promotion_stalls += 1
            return False
        refs = list(match.host_refs)
        try:
            sig, blocks = self.tier.promote(refs)
        except HostPageCorruption as e:
            # corrupt bytes never reach the device; the tier freed the
            # entry's slots, the trie drops its refs, the request is
            # planned again and prefilled cold
            self.pool.free(pages)
            self.pool.release(list(match.pages))
            self.prefix.scrub_host_sites(match)
            self.stats.host_checksum_failures += 1
            self.stats.host_corrupt_pages += e.bad
            self.stats.cold_prefill_fallbacks += 1
            if self.supervisor is not None:
                self.supervisor.note_pressure("host_corrupt")
            req.plan_epoch = None
            self._prefix_epoch += 1
            self._admission_dirty = True
            return False
        self._tier_write(sig, pages, blocks)
        all_pages = self.prefix.install_promoted(match, pages)
        self.tier.note_promoted(sig, pages, refs)
        self.pool.retain(pages)         # the index owns rc 1; reader hold
        req.holds = all_pages
        req.shared_n = len(all_pages)
        req.shared_full = match.full
        self.stats.prefix_promoted_pages += n
        self.stats.prefix_promotions += 1
        self._tr.instant(PID_REQUESTS, req.uid, "promote", cat="tier",
                         args={"pages": n, "step": self.stats.steps})
        self._prefix_epoch += 1         # planned misses may now hit
        req.plan_epoch = self._prefix_epoch
        self._admission_dirty = True
        return True

    # ------------------------------------------------------------------
    # Admission control + preemption
    # ------------------------------------------------------------------

    def _preempt(self, slot: int, victim: Request,
                 slots: List[Optional[Request]],
                 sess: DecodeSession) -> None:
        """Evict a running request: snapshot its canvas + commit ring,
        release its slot and pages, requeue it at the FRONT."""
        snap = sess.snapshot_rows([slot])
        victim.snapshot = {k: v[0] for k, v in snap.items()}
        sess.release_rows([slot])
        self._release_holds(victim)      # un-copied shared pages go back
        victim.shared_n = 0
        if self.paged:
            self.pool.free(victim.pages or [])
        victim.pages = None
        victim.preemptions += 1
        self.stats.preemptions += 1
        slots[slot] = None
        self._running.pop(victim.uid, None)
        self.queue.appendleft(victim)
        tr = self._tr
        if tr.enabled:
            tr.end(PID_REQUESTS, victim.uid, "running",
                   args={"exit": "preempt"})
            tr.instant(PID_REQUESTS, victim.uid, "preempt",
                       cat="lifecycle",
                       args={"step": self.stats.steps,
                             "preemptions": victim.preemptions})
            tr.begin(PID_REQUESTS, victim.uid, "queued", cat="lifecycle",
                     args={"resumed": True})

    # ------------------------------------------------------------------
    # Fault handling
    # ------------------------------------------------------------------

    def _inject_nan(self, slots: List[Optional[Request]],
                    sess: DecodeSession) -> None:
        """Arm a NaN poisoning of one live row's cache pages, picked from
        the fire's index.  The session applies it inside its next
        ``step()`` after the refresh (so ``refresh_interval=1`` cannot wash
        it out).  Rows still holding shared pages they have not copied are
        never picked: poisoning a shared page would taint other requests
        through the index."""
        if not self.paged or self.faults is None:
            return
        victims = [s for s in slots
                   if s is not None and not s.canceled and s.fault is None
                   and s.pages and not s.holds]
        if not victims:
            return
        k = self.faults.fired["step_nan"] - 1   # this probe already fired
        pick = victims[choose_index(self.faults.plan.seed, "nan_row", k,
                                    len(victims))]
        sess.poison_pages_after_refresh(pick.pages)

    def _disconnect_burst(self, slots: List[Optional[Request]]) -> None:
        """Every streaming request of the batch loses its client at once: a
        cancellation each; the dead-row scan reaps them this iteration."""
        hit = 0
        for s in slots:
            if (s is not None and not s.canceled and s.fault is None
                    and (s.stream or s.sink is not None)):
                s.canceled = True
                hit += 1
        if hit:
            self.stats.disconnect_bursts += 1
            if self.supervisor is not None:
                self.supervisor.note_pressure("disconnect")

    def _watchdog_recover(self, lane: LaneKey,
                          slots: List[Optional[Request]],
                          sess: DecodeSession) -> None:
        """The watchdog fired: the lane made no progress for a whole
        budget.  Finalize the rows already canceled or faulted,
        force-preempt the rest back to the queue through their snapshots,
        and clear an injected stall so the rebuilt lane can run."""
        self.stats.watchdog_fires += 1
        dead = [i for i, s in enumerate(slots)
                if s is not None and (s.canceled or s.fault is not None)]
        for i in dead:
            req = slots[i]
            slots[i] = None
            self._finalize_aborted(req)
        if dead:
            if self.paged:
                sess.release_rows(dead)
            else:
                sess.deactivate_rows(dead)
        for i, r in enumerate(slots):
            if r is not None:
                self._preempt(i, r, slots, sess)
        if self.faults is not None:
            self.faults.clear_stall(lane)
        if self.supervisor is not None:
            self.supervisor.note_pressure("watchdog")
            self.supervisor.lane_started()

    def _admit_one(self, lane: LaneKey, slots: List[Optional[Request]],
                   sess: Optional[DecodeSession],
                   protected: Tuple[int, ...] = ()) -> Optional[Request]:
        """Admit one lane request: it needs a free SLOT and (paged mode)
        enough free PAGES.  When either is short, strictly lower-priority
        running requests are preempted, lowest priority first and most
        recently started first within a priority (effective priorities
        under an SLO policy), until the candidate fits; if they cannot
        cover it the candidate stalls and the next candidate gets a
        chance.  With the prefix index, a page shortage
        first evicts reader-less index entries, but only when that (with
        the preemptible victims) can admit the candidate.  An allocation
        that fails anyway (an injected ``pool_alloc`` fault) is retried
        after 1, 2, 4, ... steps, and past ``max_alloc_retries`` the request
        is aborted.  Returns the admitted request (popped from the queue,
        pages allocated) or None.  ``protected`` slots were admitted this
        swap round and have no session state yet, so they are never
        victims."""
        stalled = False
        now = self._now()
        for req in self._lane_candidates(lane):
            if req.retry_after_step > self.stats.steps:
                stalled = True      # backing off a transient alloc fault
                continue
            slot_free = any(s is None for s in slots)
            if not self.paged:
                if not slot_free:
                    return None     # dense mode: no preemption
                self.queue.remove(req)
                self._admit_bookkeep(req)
                return req
            # plan the prefix hit FIRST: its read holds protect the
            # matched entry from this admission's own index eviction
            self._plan(req)
            page_short = (max(0, req.n_pages - self.pool.available)
                          if req.n_pages else 0)
            victims = []
            if sess is not None:
                req_eff = self._eff_priority(req, now)
                victims = sorted(
                    ((i, r) for i, r in enumerate(slots)
                     if r is not None and i not in protected
                     and self._eff_priority(r, now) < req_eff),
                    key=lambda ir: (self._eff_priority(ir[1], now),
                                    -(ir[1].started_at or 0.0)))
            freeable = sum(len(r.pages or []) for _, r in victims)
            if page_short and self.prefix is not None:
                # evict before preempting, and never for a candidate that
                # stalls anyway (that would trade future hits for nothing)
                feasible = (
                    (slot_free or victims)
                    and self.pool.available + freeable
                    + self.prefix.evictable_total(self.pool)
                    >= req.n_pages)
                if feasible and self._evict_index(page_short):
                    page_short = max(0, req.n_pages - self.pool.available)
            if page_short or not slot_free:
                if (sess is None
                        or self.pool.available + freeable < req.n_pages
                        or (not slot_free and not victims)):
                    self._drop_plan(req)
                    stalled = True
                    continue        # a smaller/later candidate may fit
                for i, r in victims:
                    self._preempt(i, r, slots, sess)
                    if (self.pool.available >= req.n_pages
                            and any(s is None for s in slots)):
                        break
            pages = self.pool.alloc(req.n_pages) if req.n_pages else []
            if pages is None:
                # a transient allocation fault (a real shortage was settled
                # above by eviction or preemption): retry with exponential
                # backoff on the step clock, then abort the request
                self._drop_plan(req)
                self.stats.alloc_faults += 1
                req.alloc_retries += 1
                max_r = (self.supervisor.cfg.max_alloc_retries
                         if self.supervisor is not None else 3)
                if req.alloc_retries > max_r:
                    self.queue.remove(req)
                    req.fault = "pool_alloc"
                    self._finalize_aborted(req)
                else:
                    req.retry_after_step = (
                        self.stats.steps + (1 << (req.alloc_retries - 1)))
                if self.supervisor is not None:
                    self.supervisor.note_pressure("pool_alloc")
                stalled = True
                continue
            self.queue.remove(req)
            req.pages = pages
            self._count_prefix_hit(req)
            self._admit_bookkeep(req)
            return req
        if stalled:
            self.stats.admission_stalls += 1
        return None

    def _admit_bookkeep(self, req: Request) -> None:
        self._running[req.uid] = req   # cancel() finds in-flight by uid
        tr = self._tr
        if tr.enabled:
            tr.end(PID_REQUESTS, req.uid, "queued")
            kind = ("resume" if req.preemptions > 0
                    else "full_hit" if req.shared_full
                    else "partial_prefill" if req.shared_n
                    else "prefill")
            tr.begin(PID_REQUESTS, req.uid, "running", cat="lifecycle",
                     args={"prefill": kind, "pages": req.n_pages,
                           "shared_pages": req.shared_n})

    # ------------------------------------------------------------------
    # Canvas rows
    # ------------------------------------------------------------------

    def _canvas_row(self, req: Request):
        """(tokens [N], active [N], committed or None, prompt_len) for one
        slot.  A preempted request resumes from its snapshot: the partly
        committed canvas, active mask and commit ring."""
        if req.snapshot is not None:
            snap = req.snapshot
            req.snapshot = None
            p_len = min(len(req.prompt), self.canvas_len - req.gen_len)
            return (snap["tokens"].copy(), snap["active"].copy(),
                    snap["committed"].copy(), p_len)
        row = np.full((self.canvas_len,), self.cfg.mask_id, np.int32)
        p = req.prompt[: self.canvas_len - req.gen_len]
        row[: len(p)] = p
        active = np.zeros((self.canvas_len,), bool)
        active[len(p): len(p) + req.gen_len] = True
        return row, active, None, len(p)

    def _pt_row(self, req: Request) -> List[int]:
        return self.pool.page_table_row(req.pages or [], self.canvas_len)

    def _harvest(self, req: Request, toks_row: np.ndarray,
                 p_len: int) -> None:
        req.output = toks_row[p_len: p_len + req.gen_len].copy()
        req.completed_at = self._now()
        e2e = req.completed_at - req.submitted_at
        self.stats.e2e_latencies.append(e2e)
        if req.started_at is not None:
            self.stats.queue_waits.append(req.started_at - req.submitted_at)
        ttft = float("inf")
        if req.first_token_at is not None:
            ttft = req.first_token_at - req.submitted_at
            self.stats.ttft_latencies.append(ttft)
            if req.last_commit_at is not None and req.tokens_done > 1:
                self.stats.tpot_latencies.append(
                    (req.last_commit_at - req.first_token_at)
                    / (req.tokens_done - 1))
        if req.slo is None or req.slo.met(ttft, e2e):
            self.stats.slo_met += 1
        else:
            self.stats.slo_missed += 1
        if self.paged:
            self._release_holds(req)
            if req.pages:
                self.pool.free(req.pages)
                req.pages = None
        self._running.pop(req.uid, None)
        self.done.append(req)
        self.stats.requests_done += 1
        tr = self._tr
        if tr.enabled:
            tr.end(PID_REQUESTS, req.uid, "running",
                   args={"exit": "done", "steps": req.served_steps})
            tr.end(PID_REQUESTS, req.uid, "request",
                   args={"outcome": "done", "tokens": req.tokens_done,
                         "preemptions": req.preemptions})
        self._emit(req, "done", tokens=tuple(int(t) for t in req.output))

    # ------------------------------------------------------------------

    def run(self, max_steps: int = 256, on_step=None) -> EngineStats:
        """Serve the queue to completion.  ``max_steps`` is each request's
        step budget (a request that exhausts it is harvested as it is).
        ``on_step(engine)`` fires after every engine step; submissions made
        from it join the live run and are admitted mid-loop.  The mailbox
        is drained and hopeless requests shed before each lane."""
        t0 = self._now()
        while True:
            self._drain_mailbox()
            self._shed_hopeless()
            if not self.queue:
                break
            steps0 = self.stats.steps
            self._run_lane(self.queue[0].lane, max_steps, on_step)
            if self.queue and self.stats.steps == steps0:
                # nothing admitted (every candidate backs off a transient
                # alloc fault): tick the step clock so the backoffs expire
                # instead of spinning; max_alloc_retries bounds it
                self.stats.steps += 1
        self._wall = self._now() - t0
        self._note_pool_stats()
        return self.stats

    def run_online(self, stop: threading.Event, *, max_steps: int = 256,
                   idle_wait: float = 0.01, on_step=None) -> EngineStats:
        """Serve arrivals until ``stop`` is set: the front end's engine
        thread loop.  While idle it blocks on the mailbox; while serving,
        arrivals ride the overlap point into the live batch.  On stop,
        in-flight requests are aborted (canceled, resources released) and
        queued requests stay queued with their prefix plans dropped, so the
        engine can be resumed or drained later."""
        self._stop = stop
        t0 = self._now()
        try:
            while not stop.is_set():
                self._drain_mailbox()
                self._shed_hopeless()
                if self.queue:
                    steps0 = self.stats.steps
                    self._run_lane(self.queue[0].lane, max_steps, on_step)
                    if self.queue and self.stats.steps == steps0:
                        self.stats.steps += 1   # idle tick, as in run()
                    continue
                try:
                    fn = self._mailbox.get(timeout=idle_wait)
                except queue_mod.Empty:
                    continue
                fn()
        finally:
            self._stop = None
            self._drain_mailbox()
            for r in list(self.queue):   # stopping never leaks holds
                self._drop_plan(r)
            self._wall = self._now() - t0
            self._note_pool_stats()
        return self.stats

    def _note_pool_stats(self) -> None:
        if self.faults is not None:
            self.stats.faults_injected = self.faults.total_fired
        if self.paged:
            self.stats.peak_pool_util = (self.pool.peak_used
                                         / max(self.pool.capacity, 1))
            self.stats.steady_pool_util = self.pool.steady_utilization
        if self.host_pool is not None:
            self.stats.peak_host_util = (self.host_pool.peak_units
                                         / max(self.host_pool.capacity_units,
                                               1))

    def _run_lane(self, lane: LaneKey, max_steps: int,
                  on_step=None) -> None:
        sess = self._session_for(lane)
        strategy = lane[1]
        tr = self._tr
        lid = self._lane_id(lane)
        slots: List[Optional[Request]] = [None] * self.max_batch
        batch: List[Request] = []
        while len(batch) < self.max_batch:
            req = self._admit_one(lane, slots, sess=None)
            if req is None:
                break
            batch.append(req)
        if not batch:
            return
        # dense lanes size the canvas to the actual batch; paged lanes keep
        # max_batch rows so slots freed later can admit without a reshape
        b = self.max_batch if self.paged else len(batch)
        slots = [None] * b
        now = self._now()
        tokens = np.full((b, self.canvas_len), self.cfg.mask_id, np.int32)
        active = np.zeros((b, self.canvas_len), bool)
        committed0 = np.full((b, lane[0].commit_ring), -1, np.int32)
        kv = np.zeros((b,), np.int32)
        n_log = (n_logical_pages(self.canvas_len, self.page_size)
                 if self.paged else 0)
        pt = np.zeros((b, n_log), np.int32)
        p_lens = [0] * b
        ages = [0] * b                 # max_steps budget is PER REQUEST
        shared: List[SharedPrefix] = []
        for i, req in enumerate(batch):
            row, act, com, p_len = self._canvas_row(req)
            tokens[i], active[i] = row, act
            if com is not None:
                committed0[i] = com
            slots[i] = req
            p_lens[i] = p_len
            ages[i] = req.served_steps
            kv[i] = req.row_len
            if self.paged and strategy.uses_cache:
                pt[i], spec = self._attach_spec(req, i)
                if spec is not None:
                    shared.append(spec)
            if req.started_at is None:
                req.started_at = now
        if self.paged:
            sess.cow_callback = functools.partial(self._on_cow, slots)
            arenas = (self.pool.arenas_for(strategy)
                      if strategy.uses_cache else None)
            sess.attach(tokens, active=active, kv_len=kv, arenas=arenas,
                        page_table=pt, shared=shared or None)
            for req in batch:
                self._maybe_publish(req, sess)
        else:
            sess.attach(tokens, active=active)
        if (committed0 != -1).any():
            sess.state = sess.state._replace(committed=torch.as_tensor(
                committed0).to(self.device))

        sup = self.supervisor
        guard = sup is not None and self.paged    # the NaN canvas guard
        if sup is not None:
            sup.lane_started()
        while any(s is not None for s in slots):
            if self.faults is not None and self.faults.stall_lane(lane):
                # a stuck lane: the step is never launched (a hung device).
                # Host work and the step clock go on, so the watchdog fires
                # within its budget and force-preempts the lane
                self._host_overlap(lane, slots)
                self.stats.steps += 1
                if on_step is not None:
                    on_step(self)
                if sup is not None:
                    if sup.watchdog(progressed=False):
                        self._watchdog_recover(lane, slots, sess)
                    sup.on_iteration()
                continue
            if self.faults is not None and self.faults.fire("step_nan"):
                self._inject_nan(slots, sess)
            if tr.enabled:
                tr.begin(PID_ENGINE, lid, "dispatch", cat="phase")
            info = sess.step()
            # the step is launched but not synced: mailbox intake, SLO
            # shedding and the next candidate's prefix plan run on the
            # host while it runs on the card
            if tr.enabled:
                self._phase_end(lid, "dispatch")
                tr.begin(PID_ENGINE, lid, "host_overlap", cat="phase")
            self._host_overlap(lane, slots)
            if tr.enabled:
                self._phase_end(lid, "host_overlap")
            self.stats.steps += 1
            if self.paged:
                self.pool.note_step()
            # the guard's flags are copied behind the step without a wait
            # of their own: they are on the host once the sync below returns
            row_finite = (info["row_finite"].to("cpu", non_blocking=True)
                          if guard else None)
            if tr.enabled:
                tr.begin(PID_ENGINE, lid, "host_sync", cat="phase")
            n_comm = info["n_committed"].cpu().numpy()   # first host sync
            if tr.enabled:
                self._phase_end(lid, "host_sync")
                if self.paged:
                    tr.counter(PID_ENGINE, "pool_pages",
                               {"used": self.pool.used,
                                "free": self.pool.available})
                if self.host_pool is not None:
                    tr.counter(PID_ENGINE, "host_tier_units",
                               {"used": self.host_pool.used_units})
                tr.counter(PID_ENGINE, "queue_depth",
                           {"queued": len(self.queue),
                            "running": len(self._running)})
            self.stats.tokens_committed += int(n_comm.sum())
            # cache-dynamics sampling: host-side proxy diffing after the
            # step's first host sync, never on the launch path
            dyn = self.telemetry.dynamics_every
            if dyn and strategy.uses_cache and self.stats.steps % dyn == 0:
                self._note_cache_dynamics(
                    sess, strategy, n_live=sum(s is not None for s in slots))
            if self.faults is not None and self.faults.fire("disconnect"):
                self._disconnect_burst(slots)
            nan_rows = (sup.nan_guard({"row_finite": row_finite.numpy()},
                                      slots) if guard else [])
            if on_step is not None:
                on_step(self)
            now = self._now()
            for i, s in enumerate(slots):     # TTFT / TPOT bookkeeping
                if s is None or s.fault is not None or n_comm[i] <= 0:
                    continue
                if s.first_token_at is None:
                    s.first_token_at = now
                s.last_commit_at = now
                s.tokens_done += int(n_comm[i])
            self._stream_tokens(slots, sess, p_lens)
            n_masked = sess.state.n_masked.cpu().numpy()
            finished, dead = [], []
            for i, s in enumerate(slots):
                if s is None:
                    continue
                ages[i] += 1
                s.served_steps = ages[i]
                if s.canceled or s.fault is not None:
                    dead.append(i)
                elif n_masked[i] <= 0 or ages[i] >= max_steps:
                    finished.append(i)
            progressed = bool(int(n_comm.sum()) > 0 or finished or dead)
            if sup is not None:
                if tr.enabled:
                    tr.begin(PID_ENGINE, lid, "supervisor", cat="phase")
                fired = sup.watchdog(progressed)
                if fired:
                    self._watchdog_recover(lane, slots, sess)
                else:
                    sup.on_iteration()
                if tr.enabled:
                    self._phase_end(lid, "supervisor")
                if fired:
                    continue
            if not (finished or dead) and not (self.continuous
                                               and self._admission_dirty):
                continue
            if finished or dead:
                toks = sess.host_tokens()
                for i in finished:
                    self._harvest(slots[i], toks[i], p_lens[i])
                    slots[i] = None
                for i in dead:
                    req = slots[i]
                    slots[i] = None
                    self._finalize_aborted(req)
                if self.paged:
                    # zero the rows' page-table entries BEFORE their pages
                    # can be re-allocated below: a stale entry would let
                    # the dead row's next write-back corrupt the new owner
                    sess.release_rows(finished + dead)
            if nan_rows:
                # NaN quarantine: the poisoned rows died above; every
                # surviving lane-mate is force-preempted, so the batch is
                # rebuilt from preemption snapshots and one poisoned canvas
                # never taints its neighbours' outputs
                self.stats.nan_quarantines += len(nan_rows)
                for i, r in enumerate(slots):
                    if r is not None:
                        self._preempt(i, r, slots, sess)
                continue
            swap_rows, swap_tokens, swap_active = [], [], []
            swap_kv, swap_pt, swap_com = [], [], []
            swap_shared: List[SharedPrefix] = []
            while self.continuous:
                # fill every empty slot (and let _admit_one MAKE one by
                # preempting a lower-priority row) until admission stalls
                # or the queue drains
                req = self._admit_one(lane, slots, sess,
                                      protected=tuple(swap_rows))
                if req is None:
                    break
                i = next(j for j, s in enumerate(slots) if s is None)
                row, act, com, p_len = self._canvas_row(req)
                slots[i] = req
                p_lens[i] = p_len
                ages[i] = req.served_steps
                if req.started_at is None:
                    req.started_at = self._now()
                swap_rows.append(i)
                swap_tokens.append(row)
                swap_active.append(act)
                swap_kv.append(req.row_len)
                if self.paged and strategy.uses_cache:
                    pt_row, spec = self._attach_spec(req, i)
                    swap_pt.append(pt_row)
                    if spec is not None:
                        swap_shared.append(spec)
                else:
                    swap_pt.append([0] * n_log)
                swap_com.append(com if com is not None else np.full(
                    (committed0.shape[1],), -1, np.int32))
            self._admission_dirty = False
            if swap_rows:
                if self.paged:
                    sess.replace_rows(
                        swap_rows, np.stack(swap_tokens),
                        np.stack(swap_active),
                        row_kv_len=np.asarray(swap_kv, np.int32),
                        row_page_table=np.asarray(swap_pt, np.int32),
                        row_committed=np.stack(swap_com),
                        row_shared=swap_shared or None)
                    for i in swap_rows:
                        self._maybe_publish(slots[i], sess)
                else:
                    sess.replace_rows(swap_rows, np.stack(swap_tokens),
                                      np.stack(swap_active))
                self.stats.swaps += len(swap_rows)
            parked = [i for i in finished + dead if i not in swap_rows
                      and slots[i] is None]
            if parked and not self.paged:   # paged rows released above
                sess.deactivate_rows(parked)
        if (self.paged and strategy.uses_cache and sess.state is not None
                and isinstance(sess.state.cache, PagedCache)):
            self.pool.store_arenas(strategy, sess.state.cache.arenas)
