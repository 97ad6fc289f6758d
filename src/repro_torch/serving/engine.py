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

``cancel(uid)`` aborts a queued or running request and releases its
slot, pages and prefix read holds.

Fault injection and supervision, SLO scheduling, telemetry, profiling and
the streaming front end wait for later slices: their constructor arguments
raise ``NotImplementedError``.
So does a model with recurrent layers (the RG-LRU hybrid): serving it in
lanes waits for a later slice, since its bidirectional recurrence reaches
past a short row's ``kv_len`` and stratified selection spends its quotas
there.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTENTION_KINDS, ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import PagedCache, n_logical_pages
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm.decoding import (DecodeSettings,
                                      partial_prefill_supported)
from repro_torch.dlm.scheduler import UnmaskScheduler, resolve_scheduler
from repro_torch.dlm.session import DecodeSession, SharedPrefix
from repro_torch.serving.hier import (HostPageCorruption, HostPagePool,
                                      TierManager)
from repro_torch.serving.pool import OutOfPages, PagePool, cache_signature
from repro_torch.serving.prefix import PrefixIndex, PrefixMatch

# (settings, strategy, scheduler): one DecodeSession per distinct key.
LaneKey = Tuple[DecodeSettings, CacheStrategy, UnmaskScheduler]

# Constructor arguments of the engine parts that wait for later slices,
# with the value that means "off".
_LATER = {"slo_policy": None, "fault_plan": None, "supervise": False,
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
    prefix_promoted_pages: int = 0  # host pages promoted back
    prefix_promotions: int = 0      # promotions served
    promotion_stalls: int = 0       # promotions abandoned (no headroom)
    host_checksum_failures: int = 0  # corrupt host pages caught
    cold_prefill_fallbacks: int = 0  # corrupted promotions served cold
    requests_canceled: int = 0
    peak_pool_util: float = 0.0
    steady_pool_util: float = 0.0
    peak_host_util: float = 0.0     # host-tier unit budget high-water
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
                 prefix_cache: bool = False,
                 host_pages: int = 0, host_dtype: str = "auto",
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
                self._drop_plan(r)
                r.canceled = True
                self._finalize_canceled(r)
                return True
        r = self._running.get(uid)
        if r is not None and not r.canceled:
            r.canceled = True     # the step loop releases slot + pages
            return True
        return False

    def _finalize_canceled(self, req: Request) -> None:
        if self.paged:
            self._release_holds(req)
            if req.pages:
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
            promote_ok=self.tier is not None and not req.no_promote)
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

    def _plan_ahead(self, lane: LaneKey) -> None:
        """Plan the lane's next admission candidate on the host while the
        step just launched runs on the card (``_admit_one`` reuses it).  A
        promotion made here queues its copies behind that step."""
        if self.prefix is not None and self._admission_dirty:
            for req in self._lane_candidates(lane)[:1]:
                if req.n_pages:
                    self._plan(req)

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
        (as the index reports them)."""
        freed, demoted, dropped = self.prefix.evict(self.pool, n_pages)
        self.stats.prefix_demoted_pages += demoted
        self.stats.prefix_dropped_pages += dropped
        if freed:
            self.stats.prefix_evicted_pages += freed
            self._prefix_epoch += 1
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
        except HostPageCorruption:
            # corrupt bytes never reach the device; the tier freed the
            # entry's slots, the trie drops its refs, the request is
            # planned again and prefilled cold
            self.pool.free(pages)
            self.pool.release(list(match.pages))
            self.prefix.scrub_host_sites(match)
            self.stats.host_checksum_failures += 1
            self.stats.cold_prefill_fallbacks += 1
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

    def _admit_one(self, lane: LaneKey, slots: List[Optional[Request]],
                   sess: Optional[DecodeSession],
                   protected: Tuple[int, ...] = ()) -> Optional[Request]:
        """Admit one lane request: it needs a free SLOT and (paged mode)
        enough free PAGES.  When either is short, strictly lower-priority
        running requests are preempted, lowest priority first and most
        recently started first within a priority, until the candidate
        fits; if they cannot cover it the candidate stalls and the next
        candidate gets a chance.  With the prefix index, a page shortage
        first evicts reader-less index entries, but only when that (with
        the preemptible victims) can admit the candidate.  Returns the
        admitted request (popped from the queue, pages allocated) or None.
        ``protected`` slots were admitted this swap round and have no
        session state yet, so they are never victims."""
        stalled = False
        for req in self._lane_candidates(lane):
            slot_free = any(s is None for s in slots)
            if not self.paged:
                if not slot_free:
                    return None     # dense mode: no preemption
                self.queue.remove(req)
                self._running[req.uid] = req
                return req
            # plan the prefix hit FIRST: its read holds protect the
            # matched entry from this admission's own index eviction
            self._plan(req)
            page_short = (max(0, req.n_pages - self.pool.available)
                          if req.n_pages else 0)
            victims = []
            if sess is not None:
                victims = sorted(
                    ((i, r) for i, r in enumerate(slots)
                     if r is not None and i not in protected
                     and r.priority < req.priority),
                    key=lambda ir: (ir[1].priority,
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
            assert pages is not None, "admission checked the free pages"
            self.queue.remove(req)
            req.pages = pages
            self._count_prefix_hit(req)
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
        if self.paged:
            self._release_holds(req)
            if req.pages:
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
        if self.host_pool is not None:
            self.stats.peak_host_util = (self.host_pool.peak_units
                                         / max(self.host_pool.capacity_units,
                                               1))
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

        while any(s is not None for s in slots):
            info = sess.step()
            self._plan_ahead(lane)    # host work while the step runs
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
