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

``run_compiled`` (the whole loop as one replayed CUDA graph) and the
serving surfaces (paged attach, row surgery, events) wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, check_device, resolve_device
from repro_torch.dlm import decoding
from repro_torch.dlm.decoding import DecodeSettings, DecodeState
from repro_torch.dlm.scheduler import UnmaskScheduler, resolve_scheduler

Params = Dict[str, Any]


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

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    def prefill(self, prompt: torch.Tensor, gen_len: int, *,
                use_cache: bool = True,
                kv_len: Optional[torch.Tensor] = None) -> DecodeState:
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
        return self.attach(canvas, active=active, n_masked=n_masked,
                           use_cache=use_cache, kv_len=kv_len)

    def attach(self, tokens: torch.Tensor, *,
               active: Optional[torch.Tensor] = None,
               n_masked: Optional[torch.Tensor] = None,
               use_cache: bool = True,
               kv_len: Optional[torch.Tensor] = None) -> DecodeState:
        """Adopt an externally built canvas (dense cache)."""
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
        self.state = DecodeState(
            tokens=tokens, cache=cache, step=0,
            committed=torch.full((b, self.settings.commit_ring), -1,
                                 dtype=torch.int32, device=self.device),
            n_masked=torch.as_tensor(n_masked).to(self.device, torch.int32),
            active=active, kv_len=kv_len)
        self.steps_taken = 0
        self.refresh_count = 0
        return self.state

    def _build_cache(self, tokens, kv_len=None):
        return self.strategy.refresh_cache(self.params, self.cfg, tokens,
                                           self.spa_proxies, kv_len=kv_len)

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def refresh(self) -> None:
        """Full cache rebuild from the current canvas.  A cache-less
        session (``NoCache`` or ``use_cache=False``) never grows one."""
        if (not self.strategy.uses_cache or self.state is None
                or not self.state.cache):
            return
        cache = self._build_cache(self.state.tokens, self.state.kv_len)
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
