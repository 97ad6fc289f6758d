"""Batched DLM serving engine on DecodeSession (the JAX package's
``serving/engine.py``: continuous batching, the paged pool, admission and
preemption).

Requests (prompt + gen_len + optional per-request DecodeSettings /
CacheStrategy / UnmaskScheduler / priority) are padded onto fixed canvas
rows and served by a ``DecodeSession`` at step granularity: when a row
finishes, its slot is swapped for the next queued request mid-loop
(``DecodeSession.replace_rows``) while sibling rows keep stepping with
their evolved caches.

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

``cancel(uid)`` aborts a queued or running request and releases its
slot and pages.

The prefix cache, the host-RAM tier, fault injection and supervision, SLO
scheduling, telemetry, profiling and the streaming front end wait for
later slices: their constructor arguments raise ``NotImplementedError``.
So does a model with recurrent layers (the RG-LRU hybrid): serving it in
lanes waits for a later slice, since its bidirectional recurrence reaches
past a short row's ``kv_len`` and stratified selection spends its quotas
there.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTENTION_KINDS, ModelConfig
from repro_torch.core.cache import PagedCache, n_logical_pages
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm.decoding import DecodeSettings
from repro_torch.dlm.scheduler import UnmaskScheduler, resolve_scheduler
from repro_torch.dlm.session import DecodeSession
from repro_torch.serving.pool import OutOfPages, PagePool

# (settings, strategy, scheduler): one DecodeSession per distinct key.
LaneKey = Tuple[DecodeSettings, CacheStrategy, UnmaskScheduler]

# Constructor arguments of the engine parts that wait for later slices,
# with the value that means "off".
_LATER = {"prefix_cache": False, "host_pages": 0, "host_dtype": "auto",
          "slo_policy": None, "fault_plan": None, "supervise": False,
          "supervisor_cfg": None, "telemetry": None, "profiler": None}


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
    preemptions: int = 0
    served_steps: int = 0           # per-request max_steps budget
    snapshot: Optional[Dict[str, np.ndarray]] = None  # preemption resume
    canceled: bool = False          # set by cancel(); the loop reaps it
    first_token_at: Optional[float] = None
    last_commit_at: Optional[float] = None
    tokens_done: int = 0            # committed so far (TPOT denominator)


def _percentile(samples: List[float], q: float) -> float:
    """numpy's linear-interpolation percentile; 0.0 with no samples."""
    return float(np.percentile(samples, q)) if samples else 0.0


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_committed: int = 0
    requests_done: int = 0
    swaps: int = 0                  # mid-loop slot replacements
    preemptions: int = 0            # running requests evicted for pages
    admission_stalls: int = 0       # admission attempts blocked on pages
    requests_canceled: int = 0
    peak_pool_util: float = 0.0
    steady_pool_util: float = 0.0
    e2e_latencies: List[float] = dataclasses.field(default_factory=list)
    queue_waits: List[float] = dataclasses.field(default_factory=list)
    ttft_latencies: List[float] = dataclasses.field(default_factory=list)
    tpot_latencies: List[float] = dataclasses.field(default_factory=list)

    def tps(self, wall: float) -> float:
        return self.tokens_committed / max(wall, 1e-9)

    def percentiles(self) -> Dict[str, float]:
        """p50/p95 end-to-end, queue-wait, TTFT and TPOT (seconds)."""
        out: Dict[str, float] = {}
        for name, xs in (("e2e", self.e2e_latencies),
                         ("wait", self.queue_waits),
                         ("ttft", self.ttft_latencies),
                         ("tpot", self.tpot_latencies)):
            out[f"{name}_p50"] = _percentile(xs, 50)
            out[f"{name}_p95"] = _percentile(xs, 95)
        return out


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 canvas_len: int = 64,
                 settings: Optional[DecodeSettings] = None,
                 strategy: Optional[CacheStrategy] = None,
                 scheduler: Optional[UnmaskScheduler] = None,
                 continuous: bool = True,
                 pool_pages: int = 0, page_size: int = 16,
                 clock: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None, **later):
        for name, value in later.items():
            if name not in _LATER:
                raise TypeError(f"unexpected argument {name!r}")
            if value != _LATER[name]:
                raise NotImplementedError(
                    f"{name}= belongs to a part of the serving engine that "
                    f"waits for a later slice of the port")
        recurrent = sorted(set(cfg.layer_kinds) - set(ATTENTION_KINDS))
        if recurrent:
            raise NotImplementedError(
                f"serving a model with {recurrent} layers ({cfg.name}) waits "
                "for a later slice of the port; decode it through "
                "DecodeSession")
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
        if self.paged:
            n_logical_pages(canvas_len, page_size)  # divisibility check
            self.pool = PagePool(cfg, n_pages=pool_pages,
                                 page_size=page_size,
                                 strategy=self.strategy, device=self.device)
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

    def _now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------------
    # Intake
    # ------------------------------------------------------------------

    def submit(self, prompt: np.ndarray, gen_len: int,
               settings: Optional[DecodeSettings] = None,
               strategy: Optional[CacheStrategy] = None,
               scheduler: Optional[UnmaskScheduler] = None,
               priority: int = 0,
               row_len: Optional[int] = None) -> int:
        """Queue one request.  Rejects requests that can never be
        scheduled (``gen_len`` outside the canvas, or more pages than the
        whole pool) instead of letting them starve the queue.  ``row_len``
        (paged mode) reserves a larger page-aligned canvas span than
        prompt + gen needs."""
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
        uid = self._next_uid
        self._next_uid += 1
        req = Request(uid, prompt.astype(np.int32), gen_len, settings,
                      strategy, scheduler, priority=priority,
                      submitted_at=self._now())
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
        self._admission_dirty = True
        self.queue.append(req)
        return uid

    def cancel(self, uid: int) -> bool:
        """Abort a queued or running request: its pages and canvas row are
        released and it finalizes with no output.  Returns False for
        unknown or finished uids."""
        for r in list(self.queue):
            if r.uid == uid:
                self.queue.remove(r)
                r.canceled = True
                self._finalize_canceled(r)
                return True
        r = self._running.get(uid)
        if r is not None and not r.canceled:
            r.canceled = True     # the step loop releases slot + pages
            return True
        return False

    def _finalize_canceled(self, req: Request) -> None:
        if self.paged and req.pages:
            self.pool.free(req.pages)
            req.pages = None
        req.completed_at = self._now()
        self._running.pop(req.uid, None)
        self._admission_dirty = True   # a slot/pages may have freed
        self.done.append(req)
        self.stats.requests_canceled += 1

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
            self._sessions[lane] = DecodeSession(
                self.params, self.cfg, strategy=strategy,
                settings=settings, scheduler=scheduler,
                spa_proxies=self._proxies_for(strategy),
                device=self.device)
        return self._sessions[lane]

    def _lane_candidates(self, lane: LaneKey) -> List[Request]:
        """Lane-matching queued requests in admission order: priority
        first, queue order within a priority."""
        matches = [(i, r) for i, r in enumerate(self.queue)
                   if r.lane == lane]
        return [r for _, r in sorted(matches,
                                     key=lambda ir: (-ir[1].priority, ir[0]))]

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
        if self.paged:
            self.pool.free(victim.pages or [])
        victim.pages = None
        victim.preemptions += 1
        self.stats.preemptions += 1
        slots[slot] = None
        self._running.pop(victim.uid, None)
        self.queue.appendleft(victim)

    def _admit_one(self, lane: LaneKey, slots: List[Optional[Request]],
                   sess: Optional[DecodeSession],
                   protected: Tuple[int, ...] = ()) -> Optional[Request]:
        """Admit one lane request: it needs a free SLOT and (paged mode)
        enough free PAGES.  When either is short, strictly lower-priority
        running requests are preempted, lowest priority first and most
        recently started first within a priority, until the candidate
        fits; if they cannot cover it the candidate stalls and the next
        candidate gets a chance.  Returns the admitted request (popped from
        the queue, pages allocated) or None.  ``protected`` slots were
        admitted this swap round and have no session state yet, so they
        are never victims."""
        stalled = False
        for req in self._lane_candidates(lane):
            slot_free = any(s is None for s in slots)
            if not self.paged:
                if not slot_free:
                    return None     # dense mode: no preemption
                self.queue.remove(req)
                self._running[req.uid] = req
                return req
            page_short = (max(0, req.n_pages - self.pool.available)
                          if req.n_pages else 0)
            if page_short or not slot_free:
                if sess is None:
                    stalled = True
                    continue
                victims = sorted(
                    ((i, r) for i, r in enumerate(slots)
                     if r is not None and i not in protected
                     and r.priority < req.priority),
                    key=lambda ir: (ir[1].priority,
                                    -(ir[1].started_at or 0.0)))
                freeable = sum(len(r.pages or []) for _, r in victims)
                if (self.pool.available + freeable < req.n_pages
                        or (not slot_free and not victims)):
                    stalled = True
                    continue        # a smaller/later candidate may fit
                for i, r in victims:
                    self._preempt(i, r, slots, sess)
                    if (self.pool.available >= req.n_pages
                            and any(s is None for s in slots)):
                        break
            pages = self.pool.alloc(req.n_pages) if req.n_pages else []
            assert pages is not None, "admission checked the free pages"
            self.queue.remove(req)
            req.pages = pages
            self._running[req.uid] = req
            return req
        if stalled:
            self.stats.admission_stalls += 1
        return None

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
        self.stats.e2e_latencies.append(req.completed_at - req.submitted_at)
        if req.started_at is not None:
            self.stats.queue_waits.append(req.started_at - req.submitted_at)
        if req.first_token_at is not None:
            self.stats.ttft_latencies.append(
                req.first_token_at - req.submitted_at)
            if req.last_commit_at is not None and req.tokens_done > 1:
                self.stats.tpot_latencies.append(
                    (req.last_commit_at - req.first_token_at)
                    / (req.tokens_done - 1))
        if self.paged and req.pages:
            self.pool.free(req.pages)
            req.pages = None
        self._running.pop(req.uid, None)
        self.done.append(req)
        self.stats.requests_done += 1

    # ------------------------------------------------------------------

    def run(self, max_steps: int = 256, on_step=None) -> EngineStats:
        """Serve the queue to completion.  ``max_steps`` is each request's
        step budget (a request that exhausts it is harvested as it is).
        ``on_step(engine)`` fires after every engine step; submissions made
        from it join the live run and are admitted mid-loop."""
        t0 = self._now()
        while self.queue:
            self._run_lane(self.queue[0].lane, max_steps, on_step)
        self._wall = self._now() - t0
        if self.paged:
            self.stats.peak_pool_util = (self.pool.peak_used
                                         / max(self.pool.capacity, 1))
            self.stats.steady_pool_util = self.pool.steady_utilization
        return self.stats

    def _run_lane(self, lane: LaneKey, max_steps: int,
                  on_step=None) -> None:
        sess = self._session_for(lane)
        strategy = lane[1]
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
                pt[i] = self._pt_row(req)
            if req.started_at is None:
                req.started_at = now
        if self.paged:
            arenas = (self.pool.arenas_for(strategy)
                      if strategy.uses_cache else None)
            sess.attach(tokens, active=active, kv_len=kv, arenas=arenas,
                        page_table=pt)
        else:
            sess.attach(tokens, active=active)
        if (committed0 != -1).any():
            sess.state = sess.state._replace(committed=torch.as_tensor(
                committed0).to(self.device))

        while any(s is not None for s in slots):
            info = sess.step()
            self.stats.steps += 1
            if self.paged:
                self.pool.note_step()
            n_comm = info["n_committed"].cpu().numpy()   # host sync
            self.stats.tokens_committed += int(n_comm.sum())
            if on_step is not None:
                on_step(self)
            now = self._now()
            for i, s in enumerate(slots):     # TTFT / TPOT bookkeeping
                if s is None or n_comm[i] <= 0:
                    continue
                if s.first_token_at is None:
                    s.first_token_at = now
                s.last_commit_at = now
                s.tokens_done += int(n_comm[i])
            n_masked = sess.state.n_masked.cpu().numpy()
            finished, dead = [], []
            for i, s in enumerate(slots):
                if s is None:
                    continue
                ages[i] += 1
                s.served_steps = ages[i]
                if s.canceled:
                    dead.append(i)
                elif n_masked[i] <= 0 or ages[i] >= max_steps:
                    finished.append(i)
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
                    self._finalize_canceled(req)
                if self.paged:
                    # zero the rows' page-table entries BEFORE their pages
                    # can be re-allocated below: a stale entry would let
                    # the dead row's next write-back corrupt the new owner
                    sess.release_rows(finished + dead)
            swap_rows, swap_tokens, swap_active = [], [], []
            swap_kv, swap_pt, swap_com = [], [], []
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
                swap_pt.append(self._pt_row(req)
                               if self.paged and strategy.uses_cache
                               else [0] * n_log)
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
                        row_committed=np.stack(swap_com))
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
