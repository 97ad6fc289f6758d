"""Page allocator of the paged serving pool (the JAX package's
``serving/pool.py``).

The pool owns ONE arena of fixed-size pages per cache buffer (K / V / H /
proxy / int8 scales) on the device, plus the host-side free list that hands
pages to requests.  A page is a composite unit: physical page ``p`` is slot
``p`` in EVERY buffer arena of a cache signature, so a request's
allocation is one integer (``row_len // page_size``) whatever buffers its
strategy keeps.

Invariants:
  * physical page 0 is the zero page: never allocated, never written (the
    paged scatters drop writes to it).  Every logical page past a request's
    ``kv_len`` maps to it, so requests of different lengths share a lane
    without padding their cache to the longest.
  * pages are refcounted: ``alloc`` hands pages out at refcount 1,
    ``retain`` adds holds, ``release`` drops one and returns the page to the
    free list at zero; ``free`` asserts the caller holds the last one.
  * arenas are per cache SIGNATURE (identifier width, incremental buffer,
    quantization): strategies that agree on it share one arena; page
    accounting is global across signatures.

The arenas are written in place by the sessions that use them, so the
tensors the pool hands out are the live ones; ``store_arenas`` re-adopts a
lane's arenas at its end, as the JAX engine does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core.strategy import CacheStrategy, resolve_strategy
from repro_torch.device import DeviceLike, resolve_device


def cache_signature(cfg: ModelConfig,
                    strategy: CacheStrategy) -> Tuple[int, bool, bool, str]:
    """Arena-shape key: strategies agreeing on this share one arena."""
    return (strategy.proxy_dim(cfg), bool(strategy.incremental),
            bool(strategy.uses_cache), cfg.cache_dtype)


class OutOfPages(RuntimeError):
    """A single request needs more pages than the whole pool owns."""


class PagePool:
    """Free-list page allocator + lazily materialized device arenas."""

    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int,
                 strategy: Optional[CacheStrategy] = None,
                 device: DeviceLike = None):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is reserved)")
        self.cfg = cfg
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = resolve_device(device)
        self.default_strategy = resolve_strategy(cfg, strategy)
        # page 0 is the zero page; 1..n_pages-1 are allocatable
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._rc: Dict[int, int] = {}   # holds per allocated page
        self._arenas: Dict[Tuple, Dict] = {}
        self.peak_used = 0
        self._util_samples: List[float] = []
        # fault seam: when set (a FaultInjector), alloc() probes
        # fault_hook.fire("pool_alloc") and fails on a hit, with the None
        # its callers already handle for a full pool
        self.fault_hook = None

    # ---- accounting --------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.capacity - self.available

    @property
    def utilization(self) -> float:
        return self.used / max(self.capacity, 1)

    def pages_for(self, row_len: int) -> int:
        """Composite pages covering a page-aligned row span."""
        return -(-row_len // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate n pages at refcount 1 (all or nothing); None when
        short."""
        if n > len(self._free):
            return None
        if n and self.fault_hook is not None \
                and self.fault_hook.fire("pool_alloc"):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def retain(self, pages: List[int]) -> None:
        """Add one hold per page."""
        for p in pages:
            assert self._rc.get(p, 0) > 0, f"retain of unallocated page {p}"
            self._rc[p] += 1

    def release(self, pages: List[int]) -> None:
        """Drop one hold per page; a page returns to the free list when its
        last hold goes."""
        for p in pages:
            assert 0 < p < self.n_pages, p
            rc = self._rc.get(p, 0)
            assert rc > 0 and p not in self._free, (p, rc)
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1

    def free(self, pages: List[int]) -> None:
        """Free pages the caller holds exclusively (the last hold);
        shared pages go through ``release``."""
        for p in pages:
            rc = self._rc.get(p, 0)
            assert rc == 1, (
                f"free of page {p} with refcount {rc}; "
                "shared pages must be release()d, not free()d")
        self.release(pages)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    @property
    def refcounts(self) -> Dict[int, int]:
        """{page: holds} for every allocated page (copy)."""
        return dict(self._rc)

    def note_step(self) -> None:
        """Sample utilization once per engine step (steady-state stat)."""
        self._util_samples.append(self.utilization)

    def reset_telemetry(self) -> None:
        """Zero peak/steady tracking without touching allocations."""
        self.peak_used = self.used
        self._util_samples.clear()

    @property
    def steady_utilization(self) -> float:
        if not self._util_samples:
            return 0.0
        return sum(self._util_samples) / len(self._util_samples)

    def free_fragmentation(self) -> Dict[str, int]:
        """Free-list fragmentation: contiguous free runs and the longest."""
        runs = max_run = cur = 0
        prev = None
        for p in sorted(self._free):
            if prev is not None and p == prev + 1:
                cur += 1
            else:
                runs += 1
                cur = 1
            max_run = max(max_run, cur)
            prev = p
        return {"free_pages": len(self._free), "free_runs": runs,
                "max_contiguous_run": max_run}

    def arena_bytes(self) -> Dict[str, int]:
        """Device bytes per materialized cache signature."""
        return {str(sig): sum(t.numel() * t.element_size()
                              for bufs in arenas.values()
                              for t in bufs.values())
                for sig, arenas in self._arenas.items()}

    def telemetry_gauges(self):
        """Occupancy gauges for the metrics registry, ``name -> (help,
        value)``: the pool owns its exposition names."""
        frag = self.free_fragmentation()
        return {
            "spa_pool_pages_used":
                ("allocated composite pages", self.used),
            "spa_pool_pages_capacity":
                ("allocatable pages", self.capacity),
            "spa_pool_utilization_ratio":
                ("used / capacity", self.utilization),
            "spa_pool_peak_utilization_ratio":
                ("high-water used / capacity",
                 self.peak_used / max(self.capacity, 1)),
            "spa_pool_peak_pages_used":
                ("high-water allocated pages", self.peak_used),
            "spa_pool_free_runs":
                ("contiguous free-page runs", frag["free_runs"]),
            "spa_pool_max_contiguous_free_run":
                ("longest contiguous free-page run",
                 frag["max_contiguous_run"]),
            "spa_pool_arena_bytes_total":
                ("device bytes across all cache-signature arenas",
                 sum(self.arena_bytes().values())),
        }

    def debug_state(self) -> Dict:
        """JSON-safe accounting, fragmentation, per-signature bytes and the
        refcount histogram (never the arena contents)."""
        rc_hist: Dict[str, int] = {}
        for rc in self._rc.values():
            rc_hist[str(rc)] = rc_hist.get(str(rc), 0) + 1
        return {
            "capacity": self.capacity, "used": self.used,
            "available": self.available, "peak_used": self.peak_used,
            "utilization": round(self.utilization, 6),
            "steady_utilization": round(self.steady_utilization, 6),
            "page_size": self.page_size,
            "fragmentation": self.free_fragmentation(),
            "arena_bytes": self.arena_bytes(),
            "refcount_histogram": rc_hist,
        }

    # ---- arenas ------------------------------------------------------

    def arenas_for(self, strategy: Optional[CacheStrategy] = None):
        """The device arenas of the strategy's cache signature (made on
        first use; {} for cache-less strategies)."""
        strategy = resolve_strategy(self.cfg, strategy
                                    if strategy is not None
                                    else self.default_strategy)
        if not strategy.uses_cache:
            return {}
        sig = cache_signature(self.cfg, strategy)
        if sig not in self._arenas:
            self._arenas[sig] = cache_lib.init_paged_arenas(
                self.cfg, self.n_pages, self.page_size, strategy,
                device=self.device)
        return self._arenas[sig]

    def store_arenas(self, strategy: CacheStrategy, arenas) -> None:
        """Adopt a finished lane's arenas for the next lane of the same
        signature."""
        if arenas:
            self._arenas[cache_signature(self.cfg, strategy)] = arenas

    def peek_arenas(self, sig: Tuple):
        """Stored arenas of a raw signature (None if never built)."""
        return self._arenas.get(sig)

    def put_arenas(self, sig: Tuple, arenas) -> None:
        """Store arenas under a raw signature."""
        self._arenas[sig] = arenas

    def page_table_row(self, pages: List[int], canvas_len: int
                       ) -> List[int]:
        """One request's page-table row: its pages in logical order, zero
        page entries for the tail past its row span."""
        n_log = cache_lib.n_logical_pages(canvas_len, self.page_size)
        assert len(pages) <= n_log, (len(pages), n_log)
        return list(pages) + [0] * (n_log - len(pages))
