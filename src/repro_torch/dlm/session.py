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
the active-position mask.  ``run_compiled`` (the whole loop as one
replayed CUDA graph), ``events`` and shared-prefix attachments (the prefix
cache) wait for later slices.

Stochastic schedulers draw from ``rng`` (``prefill``/``attach``): an int
seed, a ``torch.Generator``, a ``scheduler.Draws`` source, or None, which
seeds a generator with 0 on the session's device when the scheduler needs
one (so a replay is seeded by default, as in the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core.cache import PagedCache
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm import decoding
from repro_torch.dlm.decoding import DecodeSettings, DecodeState
from repro_torch.dlm.scheduler import (Draws, GeneratorDraws,
                                       UnmaskScheduler, resolve_scheduler)

Params = Dict[str, Any]

_LATER_PREFIX = ("shared-prefix attachments belong to the prefix cache, "
                 "which waits for a later slice")


class DecodeSession:
    """Owns canvas, cache, refresh and commit policy."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 strategy: Optional[CacheStrategy] = None,
                 settings: Optional[DecodeSettings] = None,
                 scheduler: Optional[UnmaskScheduler] = None,
                 spa_proxies=None, backend=None,
                 device: DeviceLike = None):
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
        self.state: Optional[DecodeState] = None
        self.steps_taken = 0
        self.refresh_count = 0
        self.last_info: Optional[Dict[str, torch.Tensor]] = None
        self._gen_span: Optional[Tuple[int, int]] = None  # semi-AR bounds
        # one host copy of the canvas per state (see host_tokens)
        self._host_tokens: Optional[np.ndarray] = None
        self._host_tokens_for: Optional[DecodeState] = None

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    def prefill(self, prompt: torch.Tensor, gen_len: int, *,
                use_cache: bool = True,
                kv_len: Optional[torch.Tensor] = None, arenas=None,
                page_table: Optional[torch.Tensor] = None,
                rng=None) -> DecodeState:
        """Build the canvas (prompt + gen_len [MASK] slots) and run the
        full prefill forward that populates the strategy's caches."""
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
                            arenas=arenas, page_table=page_table, rng=rng)
        self._gen_span = (prompt.shape[1], n)
        return state

    def attach(self, tokens: torch.Tensor, *,
               active: Optional[torch.Tensor] = None,
               n_masked: Optional[torch.Tensor] = None,
               use_cache: bool = True,
               kv_len: Optional[torch.Tensor] = None, arenas=None,
               page_table: Optional[torch.Tensor] = None,
               shared=None, rng=None) -> DecodeState:
        """Adopt an externally built canvas (the serving engine's path).

        Paged mode: pass pooled ``arenas`` ({kind: {name: [Lk, P, page,
        ...]}}) and a ``page_table`` [B, n_log]; the prefilled dense cache
        is scattered into the arenas and the state's cache becomes a
        :class:`PagedCache`.  ``kv_len`` [B] marks each row's valid canvas
        length (a shorter row owns only the pages that cover it; its tail
        maps to the zero page).  ``shared`` (prefix-cache attachments)
        raises ``NotImplementedError``."""
        if shared is not None:
            raise NotImplementedError(_LATER_PREFIX)
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        b = tokens.shape[0]
        if active is None:
            active = torch.ones_like(tokens, dtype=torch.bool)
        active = torch.as_tensor(active).to(self.device, torch.bool)
        if n_masked is None:
            n_masked = ((tokens == self.cfg.mask_id) & active).sum(
                dim=-1).to(torch.int32)
        if kv_len is not None:
            kv_len = torch.as_tensor(kv_len).to(self.device, torch.int32)
        cache = self._build_cache(tokens, kv_len) if use_cache else {}
        if arenas is not None and cache:
            if page_table is None:
                raise ValueError("a paged attach needs page_table")
            cache = cache_lib.repage(
                arenas, torch.as_tensor(page_table).to(self.device,
                                                       torch.int32),
                cache, self.strategy.backend)
        self.state = DecodeState(
            tokens=tokens, cache=cache, step=0,
            committed=torch.full((b, self.settings.commit_ring), -1,
                                 dtype=torch.int32, device=self.device),
            n_masked=torch.as_tensor(n_masked).to(self.device, torch.int32),
            active=active, kv_len=kv_len, rng=self._as_rng(rng))
        self.steps_taken = 0
        self.refresh_count = 0
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

    def _build_cache(self, tokens, kv_len=None):
        return self.strategy.refresh_cache(self.params, self.cfg, tokens,
                                           self.spa_proxies, kv_len=kv_len)

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
        cache = self._build_cache(self.state.tokens, self.state.kv_len)
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

    def step(self) -> Dict[str, torch.Tensor]:
        """One refinement step (auto-refresh applied first)."""
        assert self.state is not None, "call prefill()/attach() first"
        self._maybe_refresh()
        self.state, info = decoding.serve_step(
            self.params, self.cfg, self.state, self.settings,
            spa_proxies=self.spa_proxies, strategy=self.strategy,
            scheduler=self.scheduler)
        self.steps_taken += 1
        self.last_info = info
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
                     row_shared=None) -> None:
        """Swap canvas rows and re-prefill ONLY those rows.

        The fresh cache comes from a prefill over just the swapped rows
        (prefill is row-independent, so it matches a whole-batch prefill)
        and is written into the running cache at those rows; sibling rows
        keep their evolved caches.  Paged sessions take ``row_page_table``
        [n_swap, n_log] (the incoming requests' pages; tail entries 0) and
        ``row_kv_len`` [n_swap]: the sub-batch prefill scatters into those
        pages only.  ``row_committed`` restores a preempted request's
        commit ring; by default the ring is cleared.  ``row_shared``
        (prefix-cache attachments) raises ``NotImplementedError``."""
        if row_shared is not None:
            raise NotImplementedError(_LATER_PREFIX)
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
        if self.strategy.uses_cache and cache:
            fresh = self._build_cache(row_tokens, sub_kv)
            if isinstance(cache, PagedCache):
                if row_page_table is None:
                    raise ValueError("a paged session needs row_page_table")
                row_pt = torch.as_tensor(np.asarray(row_page_table)).to(
                    self.device, torch.int32)
                cache_lib.paged_from_dense(cache.arenas, row_pt, fresh,
                                           self.strategy.backend)
                pt = cache.page_table.clone()
                pt[idx] = row_pt
                cache = PagedCache(cache.arenas, pt)
            else:
                for kind, bufs in cache.items():
                    for name, t in bufs.items():
                        t[:, idx] = fresh[kind][name]
        self.state = st._replace(tokens=tokens, active=active,
                                 n_masked=n_masked, committed=committed,
                                 cache=cache, kv_len=kv_len)

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
