"""Host-RAM page tier under the prefix index (the JAX package's
``serving/hier.py``).

The device :class:`~repro_torch.serving.pool.PagePool` caps the prefix
index at one arena: under pressure ``PrefixIndex.evict`` would free the
least-recently used entries for good.  With this tier attached an evicted
entry is *demoted*: its pages are copied to host memory and the entry stays
in the trie; a later hit *promotes* them back into freshly allocated device
pages.

  * :class:`HostPagePool` — one host arena per cache buffer per (signature,
    representation), in pinned memory when the device is CUDA.  Capacity is
    counted in half-page units: a page stored exact costs 2, an int8 page 1,
    so the cold tier holds about twice as many int8 pages.  Arenas grow
    by doubling, in chunks that are never moved.
  * :class:`TierManager` — the demote / promote broker.  ``host_dtype``
    "f32" keeps every page exact, "int8" quantizes every float page, "auto"
    quantizes the pages whose stability (:func:`page_stability`, from the
    singular-proxy rows) clears ``stable_threshold``.  Under host pressure
    stable pages are dropped instead of demoted: they are the cheap ones to
    prefill again.

A page demoted exact (the device dtype's bytes, or an int8 cache's codes)
promotes bit-identical; a page that passed through int8 comes back within
``max|row| / 254`` per element plus the f16 scale's cast, and its entry is
inexact from then on.  Every stored page carries a crc32 of its stored
bytes, checked before any promotion reaches the device
(:class:`HostPageCorruption`).

Ordering on the card (all work runs on the current stream):

  * a demotion gathers the pages on the stream, behind the step that last
    wrote them, copies them into pinned host slots without blocking, and
    then waits for those copies before the checksum reads the host bytes;
  * a promotion copies host slots to the device without blocking the host;
    the engine's scatter into the arenas follows on the same stream, so it
    lands before the next step that reads those pages;
  * a slot freed by a promotion may still be the source of that copy, so
    the promotion records an event on it and a later store into the slot
    waits for that event.
"""
from __future__ import annotations

import bisect
import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import dequantize_rows
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.faults import flip_first_word

# host-buffer suffix for the int8 representation's per-row scales: distinct
# from the "_scale" buffers an int8 cache signature already carries (those
# pass through the host tier as they are)
_SCALE_SUFFIX = "_hscale"
_REPRS = ("exact", "int8")


def _stabilities(x: torch.Tensor) -> torch.Tensor:
    """:func:`page_stability` of ``n`` pages at once: x [n, rows, r] f32 ->
    [n] f32."""
    norms = torch.linalg.vector_norm(x, dim=-1)                  # [n, rows]
    live = norms > 1e-8
    count = live.sum(-1)
    unit = torch.where(live[..., None],
                       x / torch.where(live, norms, 1.0)[..., None], 0.0)
    mean = unit.sum(1) / count.clamp(min=1)[:, None]             # [n, r]
    mn = torch.linalg.vector_norm(mean, dim=-1)
    direction = mean / torch.where(mn < 1e-8, 1.0, mn)[:, None]
    cos = torch.einsum("nkr,nr->nk", unit, direction)
    score = (cos * live).sum(-1) / count.clamp(min=1)
    return torch.where((count == 0) | (mn < 1e-8), 0.0,
                       score.clamp(0.0, 1.0))


def page_stability(proxy_block) -> float:
    """Stability of ONE page from its identifier (singular-proxy) rows
    ``[..., rows, r]``: the mean cosine of each row to the page-mean
    direction, clipped to [0, 1].  Parallel rows (a prefill's all-[MASK]
    tail) score near 1: cheap to reproduce, safe to quantize.  Pages
    without live rows score 0.0."""
    x = torch.as_tensor(proxy_block).float()
    if x.numel() == 0:
        return 0.0
    return float(_stabilities(x.reshape(1, -1, x.shape[-1]))[0])


class HostPageCorruption(RuntimeError):
    """A host-tier page failed its checksum on promotion.  The tier has
    already freed the whole entry's slots (corrupt bytes never reach the
    device); the engine falls back to a cold prefill.  ``bad`` counts the
    entry's pages that failed."""

    def __init__(self, message: str, bad: int = 0):
        super().__init__(message)
        self.bad = bad


@dataclasses.dataclass(frozen=True)
class HostPageRef:
    """One demoted page's host-tier address.

    ``sig``: the device cache signature whose arenas the page came from
    (and promotes back into); ``repr_``: "exact" or "int8"; ``slot``: the
    slot in the (sig, repr_) host arena; ``units``: half-page units the slot
    costs; ``exact``: whether a promotion reproduces the original device
    bytes (False once the page passed through int8); ``stability``: the
    score it was demoted with; ``checksum``: crc32 of the stored bytes
    (0 = unverified)."""
    sig: Tuple
    repr_: str
    slot: int
    units: int
    exact: bool
    stability: float
    checksum: int = 0


def _host_bytes(a) -> np.ndarray:
    """A tensor or array as its contiguous host bytes (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        return a.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _blocks_checksum(blocks) -> int:
    """crc32 over every buffer of one page's block tree, kinds then names
    in sorted order, over the STORED bytes (after quantization), so the
    JAX package computes the same value for the same bytes."""
    ck = 1
    for kind in sorted(blocks):
        for name in sorted(blocks[kind]):
            ck = zlib.crc32(_host_bytes(blocks[kind][name]), ck)
    return ck


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host tier's int8 rows (the JAX ``quantize_rows_np``, on x's
    device): symmetric over the last axis in f32, a float16 scale per row.
    Each element comes back within ``scale / 2`` (= max|row| / 254) plus
    the scale's f16 cast."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _quantize_blocks(blocks):
    """int8-quantize every float buffer of a block tree (its per-row scales
    stored as ``{name}_hscale``); integer buffers pass through."""
    out = {}
    for kind, bufs in blocks.items():
        out[kind] = {}
        for name, b in bufs.items():
            if not b.is_floating_point():
                out[kind][name] = b
                continue
            q, s = quantize_rows(b)
            out[kind][name] = q
            out[kind][name + _SCALE_SUFFIX] = s
    return out


def _dequantize_blocks(blocks):
    out = {}
    for kind, bufs in blocks.items():
        out[kind] = {}
        for name, b in bufs.items():
            if name.endswith(_SCALE_SUFFIX):
                continue
            s = bufs.get(name + _SCALE_SUFFIX)
            out[kind][name] = b if s is None else dequantize_rows(b, s)
    return out


class HostPagePool:
    """Host-memory mirror of the device pool: one arena per cache buffer
    per (signature, representation), ``[slots, Lk, page, ...]`` so a slot's
    bytes are contiguous, with a global budget counted in half-page units
    (``n_pages`` exact pages = ``2 * n_pages`` units).  For a CUDA
    ``device`` the arenas are page-locked (``pin``), so copies to and from
    the card run without blocking the host.

    An arena grows as the JAX package's does, doubling from 4 slots (never
    past the slots the budget allows at its unit rate), but in chunks: a
    growth allocates a new chunk and moves no byte, so no copy in flight
    ever reads memory that was moved or freed."""

    def __init__(self, n_pages: int, *, device: DeviceLike = "cpu"):
        if n_pages <= 0:
            raise ValueError("host tier needs n_pages > 0")
        self.pin = resolve_device(device).type == "cuda"
        self.n_pages = n_pages
        self.capacity_units = 2 * n_pages
        self.used_units = 0
        self.peak_units = 0
        # (sig, repr) -> {"chunks": [{kind: {name: [c, Lk, ...]}}],
        #                 "starts": [first slot of each chunk],
        #                 "free": [slot], "n_slots": int, "max_slots": int}
        self._store: Dict[Tuple, Dict] = {}
        # (sig, repr, slot) -> event after a device-bound copy out of it
        self._reads: Dict[Tuple, torch.cuda.Event] = {}
        self.pages_in = 0      # demotions accepted, since the last reset
        self.pages_out = 0     # promotions served, since the last reset

    # ---- accounting --------------------------------------------------

    @property
    def used_pages(self) -> int:
        """Live host slots (pages resident in the tier)."""
        return sum(e["n_slots"] - len(e["free"])
                   for e in self._store.values())

    @property
    def utilization(self) -> float:
        return self.used_units / max(self.capacity_units, 1)

    def fits(self, units: int) -> bool:
        return self.used_units + units <= self.capacity_units

    def reset_telemetry(self) -> None:
        self.peak_units = self.used_units
        self.pages_in = 0
        self.pages_out = 0

    def telemetry_gauges(self):
        """Occupancy gauges (``name -> (help, value)``)."""
        return {
            "spa_tier_units_used":
                ("host-tier cost units in use (f32 page = 2, int8 = 1)",
                 self.used_units),
            "spa_tier_units_capacity":
                ("host-tier unit budget", self.capacity_units),
            "spa_tier_utilization_ratio":
                ("units used / budget", self.utilization),
            "spa_tier_resident_pages":
                ("pages resident in the host tier", self.used_pages),
            "spa_tier_peak_units_used":
                ("high-water host-tier cost units", self.peak_units),
        }

    def debug_state(self) -> Dict:
        """JSON-safe unit accounting and per-(signature, representation)
        slot occupancy (never the arena contents), and the pages in and out
        since the last :meth:`reset_telemetry`."""
        stores = {f"{sig}/{repr_}": {
            "n_slots": e["n_slots"], "free_slots": len(e["free"]),
            "resident": e["n_slots"] - len(e["free"])}
            for (sig, repr_), e in self._store.items()}
        return {
            "unit_budget": self.capacity_units,
            "units_used": self.used_units,
            "peak_units": self.peak_units,
            "utilization": round(self.utilization, 6),
            "resident_pages": self.used_pages,
            "pages_in": self.pages_in,
            "pages_out": self.pages_out,
            "stores": stores,
        }

    # ---- slots -------------------------------------------------------

    def _entry(self, sig: Tuple, repr_: str, units_per_page: int, blocks,
               n: int):
        """The (sig, repr_) arena, grown so that ``n`` slots are free."""
        e = self._store.get((sig, repr_))
        if e is None:
            e = {"chunks": [], "starts": [], "free": [], "n_slots": 0,
                 "max_slots": self.capacity_units // units_per_page}
            self._store[(sig, repr_)] = e
        if len(e["free"]) < n:
            grow = min(max(n - len(e["free"]), e["n_slots"], 4),
                       e["max_slots"] - e["n_slots"])
            e["chunks"].append({kind: {name: torch.empty(
                (grow, b.shape[0]) + tuple(b.shape[2:]), dtype=b.dtype,
                pin_memory=self.pin) for name, b in bufs.items()}
                for kind, bufs in blocks.items()})
            e["starts"].append(e["n_slots"])
            e["free"][:0] = range(e["n_slots"] + grow - 1,
                                  e["n_slots"] - 1, -1)
            e["n_slots"] += grow
        return e

    def _slot(self, sig: Tuple, repr_: str, slot: int):
        """One slot's buffers {kind: {name: [Lk, page, ...]}} (views)."""
        e = self._store[(sig, repr_)]
        c = bisect.bisect_right(e["starts"], slot) - 1
        return {kind: {name: a[slot - e["starts"][c]]
                       for name, a in bufs.items()}
                for kind, bufs in e["chunks"][c].items()}

    def store(self, sig: Tuple, repr_: str, units_per_page: int,
              blocks) -> Optional[List[int]]:
        """Copy ``blocks`` ({kind: {name: [Lk, n, ...]}}, on any device)
        into ``n`` free slots of the (sig, repr_) arena; returns the slots,
        or None when the unit budget cannot take them (the caller drops the
        pages).  Returns once the bytes are in host memory."""
        n = next(iter(next(iter(blocks.values())).values())).shape[1]
        if not self.fits(n * units_per_page):
            return None
        e = self._entry(sig, repr_, units_per_page, blocks, n)
        slots = [e["free"].pop() for _ in range(n)]
        for s in slots:
            # a promotion's copy out of this slot may still be running
            ev = self._reads.pop((sig, repr_, s), None)
            if ev is not None:
                ev.synchronize()
        on_card = False
        dst = [self._slot(sig, repr_, s) for s in slots]
        for kind, bufs in blocks.items():
            for name, b in bufs.items():
                on_card |= b.device.type == "cuda"
                # [n, Lk, ...] rows on b's device, then one copy a slot; on
                # the card the copies queue behind the kernels that wrote b
                src = b.transpose(0, 1).contiguous()
                for i, d in enumerate(dst):
                    d[kind][name].copy_(src[i], non_blocking=self.pin)
        if on_card:
            # the checksum reads these host bytes next: wait for the copies
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self.used_units += n * units_per_page
        self.peak_units = max(self.peak_units, self.used_units)
        self.pages_in += n
        return slots

    def load(self, sig: Tuple, repr_: str, slots: List[int],
             device: DeviceLike = "cpu"):
        """Blocks ({kind: {name: [Lk, n, ...]}}) of host slots, in order,
        copied to ``device``.  Read-only: pair with :meth:`free`.  On the
        card the copies run without blocking the host; anything queued on
        the stream after this call sees the copied values."""
        dev = resolve_device(device)
        src = [self._slot(sig, repr_, s) for s in slots]
        out = {}
        for kind, bufs in src[0].items():
            out[kind] = {}
            for name, a in bufs.items():
                dst = torch.empty((len(slots),) + tuple(a.shape),
                                  dtype=a.dtype, device=dev)
                for i, one in enumerate(src):
                    dst[i].copy_(one[kind][name], non_blocking=self.pin)
                out[kind][name] = dst.transpose(0, 1)
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            for s in slots:
                self._reads[(sig, repr_, s)] = ev
        return out

    def checksum(self, sig: Tuple, repr_: str, slot: int) -> int:
        """:func:`_blocks_checksum` of one resident slot's stored bytes."""
        return _blocks_checksum(self._slot(sig, repr_, slot))

    def free(self, sig: Tuple, repr_: str, slots: List[int],
             units_per_page: int) -> None:
        e = self._store[(sig, repr_)]
        for s in slots:
            assert s not in e["free"], f"double free of host slot {s}"
            e["free"].append(s)
        self.used_units -= len(slots) * units_per_page
        assert self.used_units >= 0

    def corrupt_slot(self, sig: Tuple, repr_: str, slot: int) -> None:
        """Flip the first 8 bytes of one resident slot's first buffer: the
        ``host_corrupt`` fault's payload, the smallest rot the promotion
        checksum must catch."""
        for bufs in self._slot(sig, repr_, slot).values():
            for a in bufs.values():
                flip_first_word(a)
                return


class TierManager:
    """Demotion / promotion between the device pool and the host tier.

    The engine wires ``read_pages(sig, pages) -> blocks`` (device tensors
    [Lk, n, page, ...]) to the live arenas and registers each published
    page's signature and stability; ``PrefixIndex.evict`` calls
    :meth:`demote`, the engine :meth:`promote`.  ``device`` is where
    promoted blocks land.  A device signature that is already int8 always
    demotes exact, at the int8 unit rate."""

    def __init__(self, host: HostPagePool, *, host_dtype: str = "auto",
                 stable_threshold: float = 0.9,
                 read_pages: Optional[Callable] = None,
                 device: DeviceLike = "cpu"):
        if host_dtype not in ("f32", "int8", "auto"):
            raise ValueError(f"host_dtype {host_dtype!r}: f32, int8 or auto")
        self.host = host
        self.host_dtype = host_dtype
        self.stable_threshold = stable_threshold
        self.read_pages = read_pages
        self.device = resolve_device(device)
        self._sig_of: Dict[int, Tuple] = {}       # device page -> sig
        self._stability: Dict[int, float] = {}    # device page -> score
        # why the last demote returned None: "full" (no host room),
        # "stable" (no room, and every page stable: cheap to prefill
        # again) or "store" (an injected write failure)
        self.refusal: Optional[str] = None
        # fault seam: a FaultInjector wired by the engine; demote probes
        # "host_store" (refuse the write: the victim drops) and
        # "host_corrupt" (bit-flip the fresh slot, which the promotion
        # checksum catches)
        self.injector = None
        # lifetime counts (the engine's statistics reset; these do not)
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.dropped_full = 0      # demotions refused: host tier full
        self.dropped_stable = 0    # demotions skipped: stable under pressure
        self.store_faults = 0      # injected demotion-write refusals
        self.checksum_failures = 0     # corrupt pages caught on promotion

    # ---- engine registration ----------------------------------------

    def note_published(self, sig: Tuple, pages: List[int],
                       proxy_blocks: Optional[Dict[int, torch.Tensor]]
                       ) -> None:
        """Register freshly published index pages: their signature, and
        their stability from the identifier rows (``proxy_blocks`` maps
        page -> [Lk, page_rows, r], or None for proxy-less strategies)."""
        blocks = proxy_blocks or {}
        scored = [p for p in pages if p in blocks]
        scores = {}
        if scored:
            x = torch.stack([torch.as_tensor(blocks[p]).float()
                             .reshape(-1, blocks[p].shape[-1])
                             for p in scored])
            scores = dict(zip(scored, _stabilities(x).tolist()))
        for p in pages:
            self._sig_of[p] = sig
            self._stability[p] = scores.get(p, 0.0)

    def forget(self, pages: List[int]) -> None:
        """Device pages left the index without demoting (dropped)."""
        for p in pages:
            self._sig_of.pop(p, None)
            self._stability.pop(p, None)

    def stability(self, page: int) -> float:
        return self._stability.get(page, 0.0)

    # ---- representation policy --------------------------------------

    def _sig_is_int8(self, sig: Tuple) -> bool:
        # cache_signature = (proxy_dim, incremental, uses_cache, dtype)
        return len(sig) >= 4 and sig[3] == "int8"

    def _repr_for(self, sig: Tuple, stability: float,
                  exact_in: bool) -> Tuple[str, int, bool]:
        """(repr_, units_per_page, exact_out) for one page."""
        if self._sig_is_int8(sig):
            return "exact", 1, exact_in
        if self.host_dtype == "f32":
            return "exact", 2, exact_in
        if self.host_dtype == "int8" or stability >= self.stable_threshold:
            return "int8", 1, False
        return "exact", 2, exact_in

    # ---- demote ------------------------------------------------------

    def demote(self, pages: List[int],
               exact_in: bool = True) -> Optional[List[HostPageRef]]:
        """Move one eviction unit's device pages host-ward.  Returns one
        :class:`HostPageRef` per page, or None to DROP the whole unit
        (unknown signature, no read path, the host budget cannot take it:
        a tail is all or nothing; or an injected store failure).  The
        caller releases the device pages either way."""
        self.refusal = None
        if not pages or self.read_pages is None:
            return None
        sig = self._sig_of.get(pages[0])
        if sig is None or any(self._sig_of.get(p) != sig for p in pages):
            return None
        plan = [self._repr_for(sig, self.stability(p), exact_in)
                for p in pages]
        if not self.host.fits(sum(u for _, u, _ in plan)):
            # under host pressure stable pages skip the tier (they are the
            # cheap ones to prefill again)
            self.refusal = ("stable" if all(
                self.stability(p) >= self.stable_threshold for p in pages)
                else "full")
            if self.refusal == "stable":
                self.dropped_stable += len(pages)
            else:
                self.dropped_full += len(pages)
            return None
        if self.injector is not None and self.injector.fire("host_store"):
            # the tier refuses the write and the victim drops, as when
            # the host budget is full
            self.refusal = "store"
            self.store_faults += 1
            self.dropped_full += len(pages)
            return None
        blocks = self.read_pages(sig, list(pages))
        refs: List[Optional[HostPageRef]] = [None] * len(pages)
        for repr_ in _REPRS:
            at = [i for i, (r, _, _) in enumerate(plan) if r == repr_]
            if not at:
                continue
            units = plan[at[0]][1]
            pick = slice(None) if len(at) == len(pages) else at
            sub = {kind: {name: b[:, pick] for name, b in bufs.items()}
                   for kind, bufs in blocks.items()}
            if repr_ == "int8":
                sub = _quantize_blocks(sub)
            slots = self.host.store(sig, repr_, units, sub)
            assert slots is not None        # fits() checked above
            for i, s in zip(at, slots):
                refs[i] = HostPageRef(
                    sig=sig, repr_=repr_, slot=s, units=units,
                    exact=plan[i][2], stability=self.stability(pages[i]),
                    checksum=self.host.checksum(sig, repr_, s))
        if self.injector is not None and self.injector.fire("host_corrupt"):
            r = refs[0]
            self.host.corrupt_slot(r.sig, r.repr_, r.slot)
        self.demoted_pages += len(pages)
        self.forget(pages)
        return refs

    # ---- promote -----------------------------------------------------

    def promote(self, refs: List[HostPageRef]):
        """The refs' pages as device-layout blocks ({kind: {name: [Lk, n,
        page, ...]}} on ``device``, int8 slots dequantized), freeing their
        host slots.  All refs share one signature.  Every checksum is
        verified before any slot is freed or any byte heads device-ward; a
        mismatch frees the whole entry's slots and raises
        :class:`HostPageCorruption`."""
        assert refs
        sig = refs[0].sig
        assert all(r.sig == sig for r in refs)
        bad = sum(1 for r in refs if r.checksum and self.host.checksum(
            sig, r.repr_, r.slot) != r.checksum)
        if bad:
            for r in refs:
                self.host.free(sig, r.repr_, [r.slot], r.units)
            self.checksum_failures += bad
            raise HostPageCorruption(
                f"{bad}/{len(refs)} host pages failed checksum "
                f"verification on promotion", bad)
        parts = []                      # (ref positions, blocks)
        for repr_ in _REPRS:
            at = [i for i, r in enumerate(refs) if r.repr_ == repr_]
            if not at:
                continue
            got = self.host.load(sig, repr_, [refs[i].slot for i in at],
                                 self.device)
            parts.append((at, _dequantize_blocks(got) if repr_ == "int8"
                          else got))
            for i in at:
                self.host.free(sig, repr_, [refs[i].slot], refs[i].units)
        if len(parts) == 1:
            blocks = parts[0][1]
        else:        # exact and int8 pages: back in ref order, in f32
            blocks = {}
            for kind, bufs in parts[0][1].items():
                blocks[kind] = {}
                for name, b in bufs.items():
                    out = torch.empty((b.shape[0], len(refs))
                                      + tuple(b.shape[2:]),
                                      dtype=torch.float32, device=b.device)
                    for at, got in parts:
                        out[:, at] = got[kind][name].float()
                    blocks[kind][name] = out
        self.promoted_pages += len(refs)
        self.host.pages_out += len(refs)
        return sig, blocks

    def note_promoted(self, sig: Tuple, pages: List[int],
                      refs: List[HostPageRef]) -> None:
        """Promoted pages are device pages again: keep their signature and
        carried stability, so a re-demotion skips the re-score."""
        for p, r in zip(pages, refs):
            self._sig_of[p] = sig
            self._stability[p] = r.stability

    def free_refs(self, refs: List[HostPageRef]) -> None:
        """Drop host refs without promoting (index clear / supersede)."""
        for r in refs:
            self.host.free(r.sig, r.repr_, [r.slot], r.units)
