"""DecodeSession — the decode loop (the JAX package's DESIGN.md §3).

A session owns the canvas (tokens, active-position mask, masked counts),
the strategy's cache and its lifecycle (prefill, periodic refresh) and the
commit policy (an ``UnmaskScheduler``).  The cache is updated in place
step by step.

Refresh has one source of truth: ``settings.refresh_interval`` > 0 wins,
0 falls back to the strategy's default, -1 disables refresh.

Typical use::

    params = init_params(cfg, seed=0)            # on the card
    sess = DecodeSession(params, cfg, strategy=SPACache())
    sess.prefill(prompt, gen_len)
    tokens, info = sess.run()

Serving (``serving/engine.py``) drives a session through ``attach`` with
a paged cache (``arenas=`` + ``page_table=``; the state's cache becomes a
``PagedCache``) and the row surgery of continuous batching:
``replace_rows``, ``deactivate_rows``, ``release_rows`` and
``snapshot_rows``.  ``run_blocks`` is the semi-AR block schedule through
the active-position mask; ``events`` streams a ``StepEvent`` per step.
``run_compiled`` runs ``run``'s loop with ``run``'s exact semantics (the
JAX package compiles the loop into one ``lax.while_loop``).

Profiling (the JAX package's DESIGN.md §12): ``profiler=`` takes a
``serving.profiling.StepProfiler``; a sampled ``step`` is fenced into
refresh / dispatch / device_wait segments, ``run_compiled`` is observed
as one loop, and an unsampled step runs the unprofiled path.  ``label``
names the session's device track and its lane in the trace accounting:
``core.runtime``'s tracker counts a trace of ``serve_step``,
``prefill_partial`` or ``decode_loop`` at the first call at each
signature (batch, canvas, paged or dense, cache dtype, strategy), where the
JAX session retraces its jitted function.

Shared prefixes (the engine's prefix cache): ``attach(shared=)`` and
``replace_rows(row_shared=)`` map a row's first logical pages to read-only
pages of the prefix index (``SharedPrefix``); the row's prefill runs only
over the unmatched suffix (``decoding.prefill_partial``), or not at all
when the index covers its whole span.  Before the first cache write (the
first ``step``, ``run_compiled``'s entry, or ``refresh``) the shared pages
are copied into the row's own reserve pages and its page table is patched
(copy-on-write), so no write ever reaches a page another reader sees.

Stochastic schedulers draw from ``rng`` (``prefill``/``attach``): an int
seed, a ``torch.Generator``, a ``scheduler.Draws`` source, or None, which
seeds a generator with 0 on the session's device when the scheduler needs
one (so a replay is seeded by default, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core import runtime
from repro_torch.core.cache import PagedCache
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm import decoding
from repro_torch.dlm.decoding import DecodeSettings, DecodeState
from repro_torch.dlm.scheduler import (Draws, GeneratorDraws,
                                       UnmaskScheduler, resolve_scheduler)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SharedPrefix:
    """One batch row's shared-prefix attachment.

    ``pages``: physical pages of the prefix index, mapped read-only at the
    row's logical pages [0, len(pages)); ``reserve``: the row's own pages
    of the same count.  The row's prefill reads ``pages``; right before
    its first cache write the session copies them into ``reserve`` and
    patches the page table (copy-on-write)."""
    row: int
    pages: Tuple[int, ...]
    reserve: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.pages) == len(self.reserve)


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One refinement step's outcome, for the streaming iterator."""
    step: int
    n_committed: np.ndarray      # [B] tokens committed this step
    committed: np.ndarray        # [B, ring] positions (-1 pad)
    done: bool
    refreshed: bool              # a full cache rebuild preceded this step
    # token values at the committed ring positions (-1 at ring pads); the
    # ring holds at most ``settings.commit_ring`` positions a step, so an
    # exact per-token stream diffs ``tokens`` against the previous step
    committed_tokens: Optional[np.ndarray] = None
    tokens: Optional[np.ndarray] = None   # [B, N] canvas snapshot


class DecodeSession:
    """Owns canvas, cache, refresh and commit policy."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 strategy: Optional[CacheStrategy] = None,
                 settings: Optional[DecodeSettings] = None,
                 scheduler: Optional[UnmaskScheduler] = None,
                 spa_proxies=None, backend=None,
                 device: DeviceLike = None, profiler=None, label: str = ""):
        self.device = resolve_device(device)
        check_device(params["embed"], self.device, "params")
        self.params = params
        self.cfg = cfg
        self.strategy = resolve_strategy(cfg, strategy)
        if backend is not None:
            self.strategy = self.strategy.with_backend(backend)
        self.settings = settings or DecodeSettings()
        self.scheduler = resolve_scheduler(self.settings, scheduler)
        ri = self.settings.refresh_interval
        self.refresh_interval = (0 if ri < 0
                                 else ri or self.strategy.refresh_interval)
        if spa_proxies is None:
            spa_proxies = self.strategy.build_proxies(params, cfg)
        for stack in (spa_proxies or {}).values():
            check_device(stack, self.device, "spa_proxies")
        self.spa_proxies = spa_proxies
        # a StepProfiler (serving/profiling.py) or None: the unprofiled path
        self.profiler = profiler
        self.label = label or (
            f"{self.strategy.name}/{self.strategy.backend.name}")
        # trace accounting: each wrapper counts its first call at each
        # signature, where the JAX session's jitted function traces
        tracker = runtime.compile_tracker()
        self._step_fn = tracker.wrap(self._serve_step, name="serve_step",
                                     lane=self.label,
                                     signature=self._state_signature)
        self._partial_fn = tracker.wrap(
            decoding.prefill_partial, name="prefill_partial",
            lane=self.label, signature=self._partial_signature)
        self._loop_fn = tracker.wrap(
            self._loop, name="decode_loop", lane=self.label,
            signature=lambda max_steps, can_refresh: (
                can_refresh, self._state_signature(self.state)))
        # shared-prefix rows awaiting copy-on-write: {batch row: spec}
        self._shared_pending: Dict[int, SharedPrefix] = {}
        # called with the resolved specs right after a copy-on-write (the
        # engine releases its read holds on the shared pages there)
        self.cow_callback = None
        self.state: Optional[DecodeState] = None
        self.steps_taken = 0
        self.refresh_count = 0
        self._last_step_refreshed = False
        self.last_info: Optional[Dict[str, torch.Tensor]] = None
        self._gen_span: Optional[Tuple[int, int]] = None  # semi-AR bounds
        # one host copy of the canvas per state (see host_tokens)
        self._host_tokens: Optional[np.ndarray] = None
        self._host_tokens_for: Optional[DecodeState] = None
        # cache-dynamics probe: the previous call's host copies of the
        # proxy identifier buffers and its changed-row sets
        # (cache_dynamics); host-side only, never read by the step
        self._dyn_prev: Optional[Dict[str, np.ndarray]] = None
        self._dyn_prev_sel: Optional[Dict[str, List[set]]] = None
        # pages the next step poisons after its refresh (a step_nan fault)
        self._poison_pages: Optional[List[int]] = None

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    def prefill(self, prompt: torch.Tensor, gen_len: int, *,
                use_cache: bool = True,
                kv_len: Optional[torch.Tensor] = None, arenas=None,
                page_table: Optional[torch.Tensor] = None,
                rng=None, extras=None) -> DecodeState:
        """Build the canvas (prompt + gen_len [MASK] slots) and run the
        full prefill forward that populates the strategy's caches.
        ``extras``: per-row modality stubs ({"patches": [B, F, d]} for a
        VLM, whose text canvas follows the patches)."""
        from repro_torch.dlm.noise import mask_canvas
        prompt = torch.as_tensor(prompt).to(self.device, torch.long)
        canvas = mask_canvas(prompt, gen_len, self.cfg.mask_id)
        b, n = canvas.shape
        active = torch.zeros((b, n), dtype=torch.bool, device=self.device)
        active[:, prompt.shape[1]:] = True
        n_masked = torch.full((b,), gen_len, dtype=torch.int32,
                              device=self.device)
        state = self.attach(canvas, active=active, n_masked=n_masked,
                            use_cache=use_cache, kv_len=kv_len,
                            arenas=arenas, page_table=page_table, rng=rng,
                            extras=extras)
        self._gen_span = (prompt.shape[1], n)
        return state

    def attach(self, tokens: torch.Tensor, *,
               active: Optional[torch.Tensor] = None,
               n_masked: Optional[torch.Tensor] = None,
               use_cache: bool = True,
               kv_len: Optional[torch.Tensor] = None, arenas=None,
               page_table: Optional[torch.Tensor] = None,
               shared=None, rng=None, extras=None) -> DecodeState:
        """Adopt an externally built canvas (the serving engine's path).

        Paged mode: pass pooled ``arenas`` ({kind: {name: [Lk, P, page,
        ...]}}) and a ``page_table`` [B, n_log]; the prefilled dense cache
        is scattered into the arenas and the state's cache becomes a
        :class:`PagedCache`.  ``kv_len`` [B] marks each row's valid canvas
        length (a shorter row owns only the pages that cover it; its tail
        maps to the zero page).

        ``shared``: per-row :class:`SharedPrefix` attachments (paged mode).
        A shared row's page table maps its prefix to read-only index pages;
        its prefill runs only over the unmatched suffix, or not at all when
        the whole row span is covered, and the shared pages are copied into
        the row's ``reserve`` pages right before the first cache write.

        ``extras`` (per-row modality stubs, a VLM's ``patches``) are copied
        into a fresh dict on the session's device: the state never aliases
        the caller's dict."""
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        extras = {k: torch.as_tensor(v).to(self.device)
                  for k, v in (extras or {}).items()}
        b = tokens.shape[0]
        if active is None:
            active = torch.ones_like(tokens, dtype=torch.bool)
        active = torch.as_tensor(active).to(self.device, torch.bool)
        if n_masked is None:
            n_masked = ((tokens == self.cfg.mask_id) & active).sum(
                dim=-1).to(torch.int32)
        if kv_len is not None:
            kv_len = torch.as_tensor(kv_len).to(self.device, torch.int32)
        shared = list(shared or [])
        self._shared_pending = {}
        if not (use_cache and self.strategy.uses_cache):
            cache = {}
        elif arenas is not None:
            if page_table is None:
                raise ValueError("a paged attach needs page_table")
            pt = torch.as_tensor(page_table).to(self.device, torch.int32)
            self._paged_fill(arenas, tokens, extras, kv_len, pt, shared)
            cache = PagedCache(arenas, pt)
            self._shared_pending = {s.row: s for s in shared}
        else:
            cache = self._build_cache(tokens, extras, kv_len)
        self.state = DecodeState(
            tokens=tokens, cache=cache, step=0,
            committed=torch.full((b, self.settings.commit_ring), -1,
                                 dtype=torch.int32, device=self.device),
            n_masked=torch.as_tensor(n_masked).to(self.device, torch.int32),
            active=active, kv_len=kv_len, rng=self._as_rng(rng),
            extras=extras)
        self.steps_taken = 0
        self.refresh_count = 0
        self._dyn_prev = None          # new canvas: old diffs meaningless
        self._dyn_prev_sel = None
        self._gen_span = None     # run_blocks needs a prefill()'d canvas
        return self.state

    def _as_rng(self, rng) -> Optional[Draws]:
        """Normalize the rng argument: ints seed a generator on the
        session's device; stochastic schedulers get seed 0 by default."""
        if rng is None:
            rng = 0 if self.scheduler.uses_rng else None
        if rng is None or isinstance(rng, Draws):
            return rng
        if isinstance(rng, (int, np.integer)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(rng))
            rng = gen
        if isinstance(rng, torch.Generator):
            return GeneratorDraws(rng)
        raise TypeError(f"rng must be an int, a torch.Generator, a Draws "
                        f"source or None, got {type(rng).__name__}")

    def _build_cache(self, tokens, extras, kv_len=None):
        return self.strategy.refresh_cache(self.params, self.cfg, tokens,
                                           self.spa_proxies, kv_len=kv_len,
                                           extras=extras)

    # ------------------------------------------------------------------
    # Shared-prefix attach + copy-on-write
    # ------------------------------------------------------------------

    def _paged_fill(self, arenas, tokens: torch.Tensor, extras,
                    kv_len: Optional[torch.Tensor], read_pt: torch.Tensor,
                    shared: Sequence[SharedPrefix]) -> None:
        """Prefill a (sub-)batch into pooled arenas, in place, honouring
        shared prefixes: rows without a spec get the full prefill, rows
        with one only their unmatched suffix (one partial prefill per
        suffix start), and fully covered rows nothing.  Every scatter goes
        through a write page table whose shared entries map to the zero
        page, so the shared pages are never written here; ``shared[i].row``
        indexes THIS (sub-)batch."""
        m, n = tokens.shape
        page = n // read_pt.shape[1]
        spec_by_row = {s.row: s for s in shared}
        write_pt, kv_host = read_pt, [n] * m
        if spec_by_row:
            write_pt = read_pt.clone()
            for s in spec_by_row.values():
                write_pt[s.row, :len(s.pages)] = 0
            if kv_len is not None:
                kv_host = kv_len.cpu().tolist()
        groups: Dict[int, list] = {}
        for r in range(m):
            s = spec_by_row.get(r)
            s0 = len(s.pages) * page if s else 0
            if s is not None and s0 >= kv_host[r]:
                continue                     # full hit: states are there
            groups.setdefault(s0, []).append(r)
        backend = self.strategy.backend
        for s0, rows in sorted(groups.items()):
            idx = slice(None) if len(rows) == m else self._rows(rows)
            sub_kv = kv_len[idx] if kv_len is not None else None
            sub_extras = {k: v[idx] for k, v in (extras or {}).items()}
            if s0 == 0:
                fresh = self._build_cache(tokens[idx], sub_extras, sub_kv)
            else:
                prefix_pt = read_pt[idx, :s0 // page]
                kv_view = {kind: {nm: backend.gather_pages(bufs[nm],
                                                           prefix_pt)
                                  for nm in ("k", "v")}
                           for kind, bufs in arenas.items()}
                fresh = self._partial_fn(
                    self.params, self.cfg,
                    dict(sub_extras, tokens=tokens[idx]), kv_view,
                    s0, kv_len=sub_kv, spa_proxies=self.spa_proxies,
                    strategy=self.strategy)
            cache_lib.paged_from_dense(arenas, write_pt[idx], fresh, backend)

    def copy_cache_pages(self, src: Sequence[int],
                         dst: Sequence[int]) -> None:
        """Copy physical pages src[i] -> dst[i] in this session's paged
        cache (the engine's prefix publication: a row's prefill-time pages
        are copied into index-owned pages before its first step)."""
        cache = self.state.cache
        assert isinstance(cache, PagedCache), "copy needs a paged cache"
        cache_lib.copy_arena_pages(cache.arenas, list(src), list(dst))

    def poison_cache_pages(self, pages: Sequence[int]) -> None:
        """Overwrite the float buffers of physical ``pages`` with NaN: the
        ``step_nan`` fault's payload.  The poisoned K/V reach the owning
        row's hidden states on the next step, where the supervisor's canvas
        guard catches them.  Integer buffers (int8 codes) stay intact: the
        fault models numeric bit rot, not structural damage."""
        cache = self.state.cache
        assert isinstance(cache, PagedCache), "poisoning needs a paged cache"
        blocks = cache_lib.read_arena_pages(cache.arenas, list(pages))
        poisoned = {kind: {nm: (torch.full_like(b, float("nan"))
                                if b.is_floating_point() else b)
                           for nm, b in bufs.items()}
                    for kind, bufs in blocks.items()}
        cache_lib.write_arena_pages(cache.arenas, list(pages), poisoned)

    def poison_pages_after_refresh(self, pages: Sequence[int]) -> None:
        """Arm a one-shot :meth:`poison_cache_pages` applied inside the next
        ``step()`` after its refresh, so a ``refresh_interval=1`` strategy
        cannot rebuild the pages before the step reads them (bit rot
        landing on the freshly rebuilt arena)."""
        self._poison_pages = list(pages)

    def _cow_if_shared(self) -> None:
        """Copy-on-write barrier: right before the first cache write (the
        first step, ``run_compiled``'s entry or a refresh), copy every
        pending row's shared pages into its reserve and patch the page
        table.  After this the shared pages are never written by this
        session, so other readers (and the index) keep their view."""
        if not self._shared_pending:
            return
        specs = list(self._shared_pending.values())
        self._shared_pending = {}
        cache = self.state.cache
        assert isinstance(cache, PagedCache), "shared rows need paging"
        cache_lib.copy_arena_pages(cache.arenas,
                                   [p for s in specs for p in s.pages],
                                   [p for s in specs for p in s.reserve])
        pt = cache.page_table.clone()
        for s in specs:
            pt[s.row, :len(s.reserve)] = torch.as_tensor(
                s.reserve, dtype=pt.dtype)
        self.state = self.state._replace(cache=PagedCache(cache.arenas, pt))
        if self.cow_callback is not None:
            self.cow_callback(specs)

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def refresh(self) -> None:
        """Full cache rebuild from the current canvas.  A cache-less
        session (``NoCache`` or ``use_cache=False``) never grows one.
        Paged sessions rebuild dense and scatter back into their arenas
        (zero-page tails stay zero)."""
        if (not self.strategy.uses_cache or self.state is None
                or not self.state.cache):
            return
        self._cow_if_shared()     # the rebuild scatters into every page
        cache = self._build_cache(self.state.tokens, self.state.extras,
                                  self.state.kv_len)
        old = self.state.cache
        if isinstance(old, PagedCache):
            cache = cache_lib.repage(old.arenas, old.page_table, cache,
                                     self.strategy.backend)
        self.state = self.state._replace(cache=cache)
        self.refresh_count += 1

    def _maybe_refresh(self) -> bool:
        if (self.refresh_interval and self.steps_taken
                and self.steps_taken % self.refresh_interval == 0):
            before = self.refresh_count
            self.refresh()
            return self.refresh_count > before
        return False

    def _state_signature(self, state: DecodeState):
        """What the JAX step's trace keys on, from what the session knows:
        batch and canvas, paged or dense, whether a cache, kv_len and rng
        are present, the cache dtype and the strategy (no tensor read)."""
        cache = state.cache
        return (tuple(state.tokens.shape), isinstance(cache, PagedCache),
                bool(cache), state.kv_len is None, state.rng is None,
                self.cfg.cache_dtype, self.strategy)

    @staticmethod
    def _partial_signature(params, cfg, inputs, kv_view, s0, *, kv_len,
                           **_):
        return tuple(inputs["tokens"].shape), s0, kv_len is None

    def _serve_step(self, state: DecodeState):
        return decoding.serve_step(
            self.params, self.cfg, state, self.settings,
            spa_proxies=self.spa_proxies, strategy=self.strategy,
            scheduler=self.scheduler)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare_step(self) -> None:
        self._cow_if_shared()     # first write: un-share prefix pages
        self._last_step_refreshed = self._maybe_refresh()
        if self._poison_pages:
            pages, self._poison_pages = self._poison_pages, None
            self.poison_cache_pages(pages)

    def _step(self, step_fn=None) -> Dict[str, torch.Tensor]:
        self._prepare_step()
        self.state, info = (step_fn or self._step_fn)(self.state)
        self.steps_taken += 1
        self.last_info = info
        return info

    def step(self) -> Dict[str, torch.Tensor]:
        """One refinement step (auto-refresh applied first).

        With a profiler attached and this step sampled, consecutive
        ``perf_counter`` reads split it into segments that tile it:
        ``refresh`` (copy-on-write, cache rebuild, then a device sync),
        ``dispatch`` (the step's launches issued) and ``device_wait`` (the
        sync on the step).  The fences only add syncs, so outputs are the
        same."""
        assert self.state is not None, "call prefill()/attach() first"
        prof = self.profiler
        if prof is None or not prof.should_sample(self.steps_taken):
            return self._step()
        t0 = time.perf_counter()
        self._prepare_step()
        self._sync()
        t1 = time.perf_counter()
        self.state, info = self._step_fn(self.state)
        t2 = time.perf_counter()
        self._sync()
        t3 = time.perf_counter()
        self.steps_taken += 1
        self.last_info = info
        prof.observe_step(self.label,
                          {"refresh": t1 - t0, "dispatch": t2 - t1,
                           "device_wait": t3 - t2}, t3 - t0)
        return info

    @property
    def done(self) -> bool:
        return int(self.state.n_masked.max()) <= 0

    @property
    def tokens(self) -> torch.Tensor:
        return self.state.tokens

    def host_tokens(self) -> np.ndarray:
        """Host copy of the canvas, fetched at most once per state (the
        engine's harvest reads it; without the cache each read would pay
        its own device-to-host copy)."""
        assert self.state is not None
        if self._host_tokens_for is not self.state:
            self._host_tokens = self.state.tokens.cpu().numpy()
            self._host_tokens_for = self.state
        return self._host_tokens

    def cache_dynamics(self, max_rows: int = 2048
                       ) -> Optional[Dict[str, Any]]:
        """Host-side SPA cache-dynamics probe (the JAX session's).

        Diffs the current ``proxy`` identifier buffers against the host copy
        taken on the previous call.  The rows whose proxies changed are the
        rows the strategy selected and committed in that interval (the
        commit writes the fresh proxy beside the K/V rows), so the diff
        gives per layer, without touching the step:

          * ``changed``: refreshed row count (budget utilization against
            ``k_schedule`` in the engine),
          * ``drift``: ``1 - cos(old_row, new_row)`` over the first
            ``max_rows`` changed rows, in float64,
          * ``overlap``: Jaccard overlap of this interval's changed-row set
            with the previous one (selection stability).

        Returns None on the first call after ``attach``, for cache-less
        strategies and when no proxy buffer exists.  Each call copies every
        proxy buffer to the host (in paged mode the whole arena), which
        waits for the step in flight; nothing is fed back, so decode outputs
        are the same with sampling on.
        """
        if self.state is None:
            return None
        cache = self.state.cache
        bufs = cache.arenas if isinstance(cache, PagedCache) else cache
        if not isinstance(bufs, dict):
            return None
        # a copy (the buffers are updated in place, and on the CPU .cpu()
        # and .float() alias them); bf16 -> f32 is exact, so comparisons
        # and the float64 drift equal the JAX probe's on its bf16 arrays
        cur: Dict[str, np.ndarray] = {
            kind: b["proxy"].to("cpu", torch.float32, copy=True).numpy()
            for kind, b in bufs.items()
            if isinstance(b, dict) and "proxy" in b}
        if not cur:
            return None
        prev, prev_sel = self._dyn_prev, self._dyn_prev_sel
        self._dyn_prev = cur
        if prev is None:
            return None
        out: Dict[str, Any] = {
            "refreshed": bool(self._last_step_refreshed), "kinds": {}}
        sel_now: Dict[str, List[set]] = {}
        for kind, now_arr in cur.items():
            p = prev.get(kind)
            if p is None or p.shape != now_arr.shape:
                continue
            n_layers = now_arr.shape[0]
            a = p.reshape(n_layers, -1, p.shape[-1])
            b2 = now_arr.reshape(n_layers, -1, now_arr.shape[-1])
            changed = np.any(a != b2, axis=-1)          # [L, rows]
            layers = []
            sel_now[kind] = []
            for layer in range(n_layers):
                idx = np.nonzero(changed[layer])[0]
                drift: List[float] = []
                if idx.size:
                    ii = idx[:max_rows]
                    va = a[layer, ii].astype(np.float64)
                    vb = b2[layer, ii].astype(np.float64)
                    denom = np.maximum(
                        np.linalg.norm(va, axis=-1)
                        * np.linalg.norm(vb, axis=-1), 1e-12)
                    cos = np.clip((va * vb).sum(-1) / denom, -1.0, 1.0)
                    drift = [float(x) for x in 1.0 - cos]
                cur_set = set(int(x) for x in idx)
                overlap = None
                if (prev_sel is not None and kind in prev_sel
                        and layer < len(prev_sel[kind])):
                    ps = prev_sel[kind][layer]
                    union = ps | cur_set
                    if union:
                        overlap = len(ps & cur_set) / len(union)
                layers.append({"changed": int(idx.size),
                               "rows": int(changed.shape[1]),
                               "drift": drift, "overlap": overlap})
                sel_now[kind].append(cur_set)
            out["kinds"][kind] = layers
        self._dyn_prev_sel = sel_now or prev_sel
        return out

    def run(self, max_steps: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Step until every active slot is committed (or max_steps)."""
        assert self.state is not None, "call prefill()/attach() first"
        if max_steps is None:
            max_steps = int(self.state.n_masked.max()) + 4
        n = 0
        for _ in range(max_steps):
            if self.done:          # check first, as the JAX loop does
                break
            self.step()
            n += 1
        return self.state.tokens, {"steps": n,
                                   "refreshes": self.refresh_count}

    def _loop(self, max_steps: int, can_refresh: bool) -> int:
        """``run``'s loop without step fences (``run_compiled``'s body; the
        loop is traced as a whole, so its steps are no ``serve_step``
        traces)."""
        n = 0
        while n < max_steps and not self.done:
            self._step(self._serve_step)
            n += 1
        return n

    def run_compiled(self, max_steps: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The decode loop with the JAX ``run_compiled``'s semantics: the
        copy-on-write barrier at entry, then ``run``'s check-first loop and
        refresh schedule (a rebuild before steps R, 2R, ...), so tokens,
        steps and refresh counts equal ``run``'s and a finished session
        runs 0 steps.  The JAX package compiles this loop into one
        ``lax.while_loop``; replaying the step as a CUDA graph is work for
        a later performance change.  A profiler observes the loop as a
        whole, as in the JAX package."""
        assert self.state is not None, "call prefill()/attach() first"
        self._cow_if_shared()
        if max_steps is None:
            max_steps = int(self.state.n_masked.max()) + 4
        can_refresh = bool(self.refresh_interval and self.strategy.uses_cache
                           and self.state.cache)
        prof = self.profiler
        t0 = time.perf_counter()
        n = self._loop_fn(max_steps, can_refresh)
        if prof is not None:
            self._sync()
            prof.observe_loop(self.label, n, time.perf_counter() - t0)
        return self.state.tokens, {"steps": n,
                                   "refreshes": self.refresh_count}

    def events(self, max_steps: Optional[int] = None
               ) -> Iterator[StepEvent]:
        """Streaming iterator: yields a :class:`StepEvent` after every
        step, and stops after the step that finishes the canvas."""
        assert self.state is not None, "call prefill()/attach() first"
        if max_steps is None:
            max_steps = int(self.state.n_masked.max()) + 4
        for _ in range(max_steps):
            info = self.step()
            done = self.done
            committed = self.state.committed.cpu().numpy()
            toks = self.host_tokens()
            ctoks = np.where(committed >= 0,
                             np.take_along_axis(
                                 toks, np.maximum(committed, 0), axis=-1),
                             -1).astype(np.int32)
            yield StepEvent(
                step=self.steps_taken,
                n_committed=info["n_committed"].cpu().numpy(),
                committed=committed, done=done,
                refreshed=self._last_step_refreshed,
                committed_tokens=ctoks, tokens=toks)
            if done:
                break

    def set_active(self, active: torch.Tensor) -> None:
        """Replace the commit mask; recounts open slots from the canvas."""
        assert self.state is not None
        active = torch.as_tensor(active).to(self.device, torch.bool)
        n_masked = ((self.state.tokens == self.cfg.mask_id) & active).sum(
            dim=-1).to(torch.int32)
        self.state = self.state._replace(active=active, n_masked=n_masked)

    def set_active_span(self, start: int, stop: int) -> None:
        active = torch.zeros_like(self.state.tokens, dtype=torch.bool)
        active[:, start:stop] = True
        self.set_active(active)

    def run_blocks(self, block_len: int,
                   max_steps_per_block: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Semi-AR block schedule: activate ``block_len``-wide windows left
        to right over the generation span, refreshing the cache at each
        block boundary (the committed block changes every row's
        context)."""
        assert self._gen_span is not None, "run_blocks needs prefill()"
        start, stop = self._gen_span
        total = 0
        for blk_start in range(start, stop, block_len):
            blk_end = min(blk_start + block_len, stop)
            self.set_active_span(blk_start, blk_end)
            if blk_start > start:
                self.refresh()
            cap = max_steps_per_block or 2 * block_len
            _, info = self.run(max_steps=cap)
            total += info["steps"]
        self.set_active_span(start, stop)
        return self.state.tokens, {"steps": total,
                                   "refreshes": self.refresh_count}

    # ------------------------------------------------------------------
    # Row surgery (continuous batching)
    # ------------------------------------------------------------------

    def _rows(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long,
                               device=self.device)

    def replace_rows(self, rows: Sequence[int], row_tokens: np.ndarray,
                     row_active: np.ndarray,
                     row_kv_len: Optional[np.ndarray] = None,
                     row_page_table: Optional[np.ndarray] = None,
                     row_committed: Optional[np.ndarray] = None,
                     row_shared=None,
                     row_extras: Optional[Dict[str, np.ndarray]] = None
                     ) -> None:
        """Swap canvas rows and re-prefill ONLY those rows.

        The fresh cache comes from a prefill over just the swapped rows
        (prefill is row-independent, so it matches a whole-batch prefill)
        and is written into the running cache at those rows; sibling rows
        keep their evolved caches.  Paged sessions take ``row_page_table``
        [n_swap, n_log] (the incoming requests' pages; tail entries 0) and
        ``row_kv_len`` [n_swap]: the sub-batch prefill scatters into those
        pages only.  ``row_committed`` restores a preempted request's
        commit ring; by default the ring is cleared.  ``row_shared``
        attaches shared prefix pages for incoming rows as
        ``attach(shared=)`` does; its specs carry BATCH row ids (members of
        ``rows``).  ``row_extras`` splices the incoming rows' modality stubs
        (a VLM's patches) into the state's extras."""
        assert self.state is not None
        st = self.state
        idx = self._rows(rows)
        row_tokens = torch.as_tensor(np.asarray(row_tokens)).to(
            self.device, torch.long)
        tokens = st.tokens.clone()
        tokens[idx] = row_tokens
        active = st.active.clone()
        active[idx] = torch.as_tensor(np.asarray(row_active)).to(
            self.device, torch.bool)
        n_masked = ((tokens == self.cfg.mask_id) & active).sum(
            dim=-1).to(torch.int32)
        extras = dict(st.extras or {})
        for k, v in (row_extras or {}).items():
            extras[k] = extras[k].clone()
            extras[k][idx] = torch.as_tensor(np.asarray(v)).to(
                self.device, extras[k].dtype)
        sub_extras = {k: v[idx] for k, v in extras.items()}
        committed = st.committed.clone()
        committed[idx] = (-1 if row_committed is None else torch.as_tensor(
            np.asarray(row_committed)).to(self.device, torch.int32))
        kv_len, sub_kv = st.kv_len, None
        if kv_len is not None:
            if row_kv_len is None:
                raise ValueError("a session with kv_len needs row_kv_len")
            sub_kv = torch.as_tensor(np.asarray(row_kv_len)).to(
                self.device, torch.int32)
            kv_len = kv_len.clone()
            kv_len[idx] = sub_kv
        cache = st.cache
        rows = list(rows)
        for r in rows:           # replaced rows' pending shares lapse
            self._shared_pending.pop(r, None)
        if self.strategy.uses_cache and cache:
            if isinstance(cache, PagedCache):
                if row_page_table is None:
                    raise ValueError("a paged session needs row_page_table")
                row_pt = torch.as_tensor(np.asarray(row_page_table)).to(
                    self.device, torch.int32)
                row_shared = list(row_shared or [])
                self._paged_fill(
                    cache.arenas, row_tokens, sub_extras, sub_kv, row_pt,
                    [dataclasses.replace(s, row=rows.index(s.row))
                     for s in row_shared])
                for s in row_shared:
                    self._shared_pending[s.row] = s
                pt = cache.page_table.clone()
                pt[idx] = row_pt
                cache = PagedCache(cache.arenas, pt)
            else:
                fresh = self._build_cache(row_tokens, sub_extras, sub_kv)
                for kind, bufs in cache.items():
                    for name, t in bufs.items():
                        t[:, idx] = fresh[kind][name]
        self.state = st._replace(tokens=tokens, active=active,
                                 n_masked=n_masked, committed=committed,
                                 cache=cache, kv_len=kv_len, extras=extras)

    def deactivate_rows(self, rows: Sequence[int]) -> None:
        """Park finished slots with no replacement request."""
        assert self.state is not None
        idx = self._rows(rows)
        active = self.state.active.clone()
        active[idx] = False
        n_masked = self.state.n_masked.clone()
        n_masked[idx] = 0
        self.state = self.state._replace(active=active, n_masked=n_masked)

    def release_rows(self, rows: Sequence[int]) -> None:
        """Release finished or preempted slots AND their pages: the rows'
        page-table entries drop to the zero page and their kv_len to 0, so
        the pages can go to the next admitted request without this session
        reading or writing them again (a row with kv_len 0 is masked out of
        attention and selection)."""
        self.deactivate_rows(rows)
        for r in rows:           # released rows never copy-on-write (the
            self._shared_pending.pop(r, None)   # engine drops its holds)
        idx = self._rows(rows)
        kv_len = self.state.kv_len
        if kv_len is not None:
            kv_len = kv_len.clone()
            kv_len[idx] = 0
        cache = self.state.cache
        if isinstance(cache, PagedCache):
            pt = cache.page_table.clone()
            pt[idx] = 0
            cache = PagedCache(cache.arenas, pt)
        self.state = self.state._replace(cache=cache, kv_len=kv_len)

    def snapshot_rows(self, rows: Sequence[int]) -> Dict[str, np.ndarray]:
        """Host copies of per-row canvas state (a preemption snapshot):
        tokens, active mask and commit ring, enough to resume the request
        through ``replace_rows``.  The cache is not saved: the resume
        re-prefills, which equals a periodic refresh at the resume step."""
        assert self.state is not None
        idx = np.asarray(list(rows))
        return {"tokens": self.host_tokens()[idx],
                "active": self.state.active.cpu().numpy()[idx],
                "committed": self.state.committed.cpu().numpy()[idx]}
