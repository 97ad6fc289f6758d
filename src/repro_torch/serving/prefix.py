"""Shared-prefix radix index for the paged serving engine (the JAX
package's ``serving/prefix.py``).

Most traffic shares long system prompts and few-shot templates, yet every
request re-prefills its whole prompt.  This index maps *prefill-time* cache
pages to prompt content so later requests attach them instead:

  * One radix trie per **layout root** ``(row_len, strategy.prefix_key())``.
    In a bidirectional DLM the prefill state of every position attends over
    the whole valid canvas, and every position past the prompt up to
    ``row_len`` is [MASK] at prefill, so ``row_len`` is the canvas-layout
    part of the match key.
  * Trie edges are page-sized token runs: a node at depth ``d`` owns ONE
    physical page holding the prefill states of logical page ``d``.
  * A node also carries **tail entries**: for a prompt that ends at this
    node (its loose, sub-page tokens as the key), the pages covering the
    rest of the row span.  Path + tail reproduce the publisher's whole
    prefill, so a tail match is a *full hit*: the request runs no prefill
    forward at all.

A full hit whose pages one request published with the same prompt and row
span is bit-identical to a cold prefill, so its decode matches a cold
decode bit for bit.  A partial hit reuses prefix states computed under
another canvas suffix (the staleness the strategy's drift identification
manages) and recomputes only the unmatched suffix
(``decoding.prefill_partial``).

Pages are owned by the index at one ``PagePool`` hold and gain one hold per
attached reader; readers drop theirs when they copy-on-write before their
first commit.  Under admission pressure the engine evicts least-recently
used entries whose pages have no readers (``evict``), deepest first, so a
surviving node's path to the root always has its pages.

**Host tier.** With a :class:`~repro_torch.serving.hier.TierManager`
attached (``self.tier``), eviction DEMOTES victims to host RAM instead of
freeing their states: the entry stays in the trie with ``host`` refs in
place of device pages, and a later hit promotes them back (``sites_intact``
and ``install_promoted`` are the engine's promotion handshake).  Victims go
stability first (stable pages are cheap to prefill again), least recently
used within a stability bucket.  Deepest-first eviction keeps the
invariant that along any path DEVICE pages form a contiguous logical
prefix and host refs a suffix.  Entries carry an ``exact`` flag: pages
demoted exact promote bit-identical; a page that ever passed through int8
is partial-hit class from then on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.hier import HostPageRef
from repro_torch.serving.pool import PagePool

TokenRun = Tuple[int, ...]


class Eviction(NamedTuple):
    """What one :meth:`PrefixIndex.evict` did: device pages freed, pages
    demoted to the host tier, and pages dropped (host refs pruned
    included); of the dropped, the pages the tier refused for want of
    room (or on an injected store failure), and those it skipped as stable
    under that pressure."""
    freed: int
    demoted: int
    dropped: int
    dropped_full: int = 0
    dropped_stable: int = 0


@dataclasses.dataclass
class _Tail:
    """Full-run completion for a prompt ending at the owning node: its
    states in device ``pages`` or, once demoted, in ``host`` refs;
    ``exact`` is False once they passed through int8."""
    pages: List[int]
    last_used: int
    host: Optional[List[HostPageRef]] = None
    exact: bool = True


@dataclasses.dataclass
class _Node:
    """One logical page of prompt tokens; ``page`` holds its states (or
    ``host`` after a demotion)."""
    page: Optional[int] = None
    last_used: int = 0
    children: Dict[TokenRun, "_Node"] = dataclasses.field(
        default_factory=dict)
    tails: Dict[TokenRun, _Tail] = dataclasses.field(default_factory=dict)
    host: Optional[HostPageRef] = None
    exact: bool = True


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Lookup result: ``pages`` map logical pages [0, len(pages)) of the
    request's row; ``full`` means the whole row span is covered (skip the
    prefill forward).  ``host_refs`` extend the match with host-tier pages
    the engine must promote before attaching (logical pages [len(pages),
    n_pages) in order); ``sites`` record where each matched page or ref
    lives in the trie, so the promotion can check (``sites_intact``) and
    install (``install_promoted``) against evictions in between.  ``exact``
    is False when a matched state passed through int8."""
    pages: Tuple[int, ...]
    full: bool
    exact: bool = True
    host_refs: Tuple[HostPageRef, ...] = ()
    sites: Tuple[Tuple, ...] = ()

    @property
    def n_pages(self) -> int:
        return len(self.pages) + len(self.host_refs)

    @property
    def needs_promotion(self) -> bool:
        return bool(self.host_refs)


class PrefixIndex:
    """Radix trie over page-sized prompt token runs -> physical pages."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.roots: Dict[Tuple, _Node] = {}
        self._clock = 0          # monotonic LRU clock (lookup/insert)
        # Optional[hier.TierManager], wired by the engine; None: eviction
        # drops (the single-tier index)
        self.tier = None
        # the degradation ladder's L2: while True, eviction drops victims
        # instead of demoting them (the host tier's work is shed)
        self.demote_paused = False

    # ---- keys ---------------------------------------------------------

    def _split(self, prompt: np.ndarray) -> Tuple[List[TokenRun], TokenRun]:
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        ps = self.page_size
        n_full = len(toks) // ps
        runs = [tuple(toks[i * ps: (i + 1) * ps]) for i in range(n_full)]
        return runs, tuple(toks[n_full * ps:])

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ---- queries ------------------------------------------------------

    def lookup(self, root_key: Tuple, prompt: np.ndarray,
               partial_ok: bool = True,
               promote_ok: bool = True) -> Optional[PrefixMatch]:
        """Longest page-aligned match for ``prompt`` under the layout root:
        a full-run match when the prompt ends exactly at the matched node
        and a tail entry exists, otherwise the matched prefix pages (None
        when empty or ``partial_ok`` is False).  With ``promote_ok`` the
        walk continues through host-resident entries, and the match's
        ``host_refs`` / ``sites`` describe the promotion the engine must
        make before the pages can be attached."""
        now = self._tick()
        node = self.roots.get(root_key)
        runs, loose = self._split(prompt)
        pages: List[int] = []
        host_refs: List[HostPageRef] = []
        sites: List[Tuple] = []
        exact = True
        if node is not None:
            for run in runs:
                child = node.children.get(run)
                if child is None:
                    node = None
                    break
                if child.page is not None:
                    child.last_used = now
                    pages.append(child.page)
                    sites.append(("dev", child, child.page))
                    exact = exact and child.exact
                elif child.host is not None and promote_ok:
                    child.last_used = now
                    host_refs.append(child.host)
                    sites.append(("node", child))
                    exact = exact and child.host.exact
                else:
                    node = child
                    break
                node = child
            else:
                tail = node.tails.get(loose)
                if tail is not None and tail.pages and not host_refs:
                    tail.last_used = now
                    return PrefixMatch(tuple(pages + tail.pages), True,
                                       exact=exact and tail.exact)
                if tail is not None and tail.host and promote_ok:
                    tail.last_used = now
                    return PrefixMatch(
                        tuple(pages), True,
                        exact=exact and all(r.exact for r in tail.host),
                        host_refs=tuple(host_refs) + tuple(tail.host),
                        sites=tuple(sites) + (("tail", node, loose),))
        if (pages or host_refs) and partial_ok:
            return PrefixMatch(tuple(pages), False, exact=exact,
                               host_refs=tuple(host_refs),
                               sites=tuple(sites))
        return None

    # ---- publication --------------------------------------------------

    def missing_slots(self, root_key: Tuple, prompt: np.ndarray,
                      n_pages: int) -> List[int]:
        """Read-only probe: the depths in [0, n_pages) a publication of this
        (prompt, run) would adopt: path nodes without a page, plus the whole
        tail when the loose-token entry is absent.  Lets the engine copy
        only the missing pages for a duplicate prompt."""
        runs, loose = self._split(prompt)
        node = self.roots.get(root_key)
        out: List[int] = []
        for depth, run in enumerate(runs):
            child = node.children.get(run) if node is not None else None
            if child is None or child.page is None:
                # a host-resident node counts as missing: a fresh device
                # publication supersedes the cold copy (insert frees it)
                out.append(depth)
            node = child
        if (node is None or loose not in node.tails
                or not node.tails[loose].pages):
            out.extend(range(len(runs), n_pages))
        return out

    def evictable_total(self, pool: PagePool) -> int:
        """Read-only bound: the pages :meth:`evict` could free if asked for
        everything (reader-less tails, and reader-less node pages whose
        whole subtree is itself freeable; leaf-first order makes the
        cascade exact)."""
        total = 0

        def walk(node: _Node) -> bool:
            """True if the subtree pins a page the pool cannot free."""
            nonlocal total
            stuck = False
            for tail in node.tails.values():
                if not tail.pages:
                    continue        # host-resident: no device hold
                if all(pool.refcount(p) == 1 for p in tail.pages):
                    total += len(tail.pages)
                else:
                    stuck = True
            for child in node.children.values():
                if walk(child):
                    stuck = True
            if node.page is not None:
                if not stuck and pool.refcount(node.page) == 1:
                    total += 1
                else:
                    stuck = True
            return stuck

        for root in self.roots.values():
            walk(root)
        return total

    def insert(self, root_key: Tuple, prompt: np.ndarray,
               pages: Sequence[Optional[int]]) -> List[int]:
        """Publish a full prefill run: ``pages[i]`` holds logical page
        ``i``'s states (prompt path first, then the all-[MASK] tail to the
        row span), or None for depths the caller knows are present.
        Existing entries keep their pages (the first publisher wins:
        replacing them would retarget live lookups).  Returns the pages
        NOT adopted, which the caller releases to the pool."""
        now = self._tick()
        runs, loose = self._split(prompt)
        assert len(pages) >= len(runs), (len(pages), len(runs))
        node = self.roots.setdefault(root_key, _Node())
        rejected: List[int] = []
        for depth, run in enumerate(runs):
            child = node.children.setdefault(run, _Node())
            page = pages[depth]
            if page is not None:
                if child.page is None:
                    if child.host is not None:
                        # fresh device states supersede the cold copy
                        self.tier.free_refs([child.host])
                        child.host = None
                    child.page = page
                    child.exact = True
                else:
                    rejected.append(page)
            child.last_used = now
            node = child
        tail_pages = [p for p in pages[len(runs):] if p is not None]
        if tail_pages:
            old = node.tails.get(loose)
            if old is not None and not old.pages:
                if old.host:
                    self.tier.free_refs(old.host)
                node.tails.pop(loose)
                old = None
            if old is not None:
                rejected.extend(tail_pages)
            else:
                node.tails[loose] = _Tail(tail_pages, now)
        return rejected

    # ---- eviction -----------------------------------------------------

    def _evictable(self, pool: PagePool):
        """(last_used, kind, node, tail key) units safe to drop: tails, and
        leaf node pages (no page-bearing descendant, no tail), all with no
        reader holds (pool refcount 1 = the index's own hold)."""
        units = []

        def walk(node: _Node) -> bool:
            blocked = False     # a page-bearing descendant or tail below
            for tail_key, tail in node.tails.items():
                if not tail.pages:
                    continue    # host-resident: no device hold, no block
                if all(pool.refcount(p) == 1 for p in tail.pages):
                    units.append((tail.last_used, "tail", node, tail_key))
                blocked = True
            for child in node.children.values():
                if walk(child):
                    blocked = True
            if node.page is not None:
                if not blocked and pool.refcount(node.page) == 1:
                    units.append((node.last_used, "node", node, None))
                return True
            return blocked

        for root in self.roots.values():
            walk(root)
        return units

    def _unit_key(self, unit):
        """Victim order: least recently used without a host tier; with one,
        stability first (stable state goes cold before drift-heavy state),
        least recently used within a bucket of 0.1."""
        last_used, kind, node, tail_key = unit
        if self.tier is None:
            return (0.0, last_used)
        pages = node.tails[tail_key].pages if kind == "tail" else [node.page]
        stab = sum(self.tier.stability(p) for p in pages) / max(len(pages), 1)
        return (-round(stab, 1), last_used)

    def evict(self, pool: PagePool, n_pages: int) -> Eviction:
        """Free at least ``n_pages`` device pages of reader-less entries
        (deepest first by construction).  With a host tier, victims demote
        and stay in the trie unless the tier refuses (host budget full, or
        stable under pressure) or ``demote_paused`` is set (the degradation
        ladder's L2: every victim drops); a dropped node severs the path
        through it,
        so host refs below it are pruned.  Returns the device pages freed
        (fewer when everything left has readers), how many pages were
        demoted and dropped (host refs pruned included), and which drops
        the tier refused as full or as stable."""
        freed = demoted = dropped = 0
        refused = {"full": 0, "stable": 0, "store": 0, None: 0}
        tier = None if self.demote_paused else self.tier
        while freed < n_pages:
            units = self._evictable(pool)
            if not units:
                break
            _, kind, node, tail_key = min(units, key=self._unit_key)
            if kind == "tail":
                tail = node.tails[tail_key]
                pages = list(tail.pages)
                refs = (tier.demote(pages, exact_in=tail.exact)
                        if tier is not None else None)
                if refs is not None:
                    tail.pages = []
                    tail.host = refs
                    tail.exact = all(r.exact for r in refs)
                    demoted += len(pages)
                else:
                    node.tails.pop(tail_key)
                    if tier is not None:
                        refused[tier.refusal] += len(pages)
                    if self.tier is not None:
                        self.tier.forget(pages)
                    dropped += len(pages)
            else:
                pages = [node.page]
                refs = (tier.demote(pages, exact_in=node.exact)
                        if tier is not None else None)
                if refs is not None:
                    node.host = refs[0]
                    node.exact = refs[0].exact
                    demoted += 1
                else:
                    if tier is not None:
                        refused[tier.refusal] += 1
                    if self.tier is not None:
                        self.tier.forget(pages)
                        dropped += self._prune_host(node)
                    dropped += 1
                node.page = None
            pool.release(pages)
            freed += len(pages)
        # a refused store drops as a full tier does (the JAX tier counts it
        # in dropped_full too)
        return Eviction(freed, demoted, dropped,
                        refused["full"] + refused["store"], refused["stable"])

    def _prune_host(self, node: _Node) -> int:
        """A dropped node severs the lookup path through it: host refs at or
        below it can never match again, so free them now (counted as
        drops).  Device pages below a droppable node cannot exist (deepest
        first)."""
        n = 0

        def scrub(nd: _Node, subtree: bool):
            nonlocal n
            for key in list(nd.tails):
                tail = nd.tails[key]
                if tail.host:
                    self.tier.free_refs(tail.host)
                    n += len(tail.host)
                    del nd.tails[key]
            if subtree and nd.host is not None:
                self.tier.free_refs([nd.host])
                nd.host = None
                n += 1
            for child in nd.children.values():
                scrub(child, True)

        scrub(node, False)
        return n

    # ---- promotion (host tier) ----------------------------------------

    def sites_intact(self, match: PrefixMatch) -> bool:
        """True while ``match`` still holds exactly the device pages and host
        refs recorded at lookup time; an eviction in between invalidates it
        and the engine plans again instead of promoting stale refs."""
        i = 0
        for site in match.sites:
            if site[0] == "dev":
                _, node, page = site
                if node.page != page:
                    return False
            elif site[0] == "node":
                if site[1].host is not match.host_refs[i]:
                    return False
                i += 1
            else:
                _, node, tail_key = site
                tail = node.tails.get(tail_key)
                if tail is None or not tail.host:
                    return False
                k = len(tail.host)
                if tuple(tail.host) != match.host_refs[i:i + k]:
                    return False
                i += k
        return i == len(match.host_refs)

    def install_promoted(self, match: PrefixMatch,
                         new_pages: Sequence[int]) -> List[int]:
        """Point ``match``'s host-resident entries at the device pages the
        engine has just written (it owns the index hold on them).  Entries
        keep their refs' exactness.  Returns the whole logical page run
        (device prefix, then the promoted pages)."""
        assert len(new_pages) == len(match.host_refs)
        now = self._tick()
        i = 0
        for site in match.sites:
            if site[0] == "dev":
                continue
            if site[0] == "node":
                node = site[1]
                node.page = new_pages[i]
                node.exact = match.host_refs[i].exact
                node.host = None
                node.last_used = now
                i += 1
            else:
                _, node, tail_key = site
                tail = node.tails[tail_key]
                k = len(tail.host)
                tail.pages = list(new_pages[i:i + k])
                tail.exact = all(r.exact for r in tail.host)
                tail.host = None
                tail.last_used = now
                i += k
        return list(match.pages) + list(new_pages)

    def scrub_host_sites(self, match: PrefixMatch) -> None:
        """Corruption fallback: drop ``match``'s host-resident entries
        WITHOUT freeing tier slots (the tier freed them when the checksum
        failed), so a later lookup misses instead of promoting rot."""
        for site in match.sites:
            if site[0] == "node":
                site[1].host = None
            elif site[0] == "tail":
                _, node, tail_key = site
                tail = node.tails.get(tail_key)
                if tail is not None and tail.host:
                    tail.host = None
                    if not tail.pages:
                        node.tails.pop(tail_key)

    def clear(self, pool: PagePool) -> int:
        """Release every index hold (readers keep theirs), free every host
        ref, and drop the trie.  Returns the device holds released."""
        pages = self.device_pages()
        pool.release(pages)
        if self.tier is not None:
            self.tier.free_refs(self._host_refs())
        self.roots = {}
        return len(pages)

    # ---- stats --------------------------------------------------------

    @property
    def held_pages(self) -> int:
        return len(self.device_pages())

    def device_pages(self) -> List[int]:
        """Every page the trie holds (one index hold each)."""
        out: List[int] = []

        def walk(node: _Node):
            if node.page is not None:
                out.append(node.page)
            for tail in node.tails.values():
                out.extend(tail.pages)
            for child in node.children.values():
                walk(child)

        for root in self.roots.values():
            walk(root)
        return out

    def _host_refs(self) -> List[HostPageRef]:
        """Every host-tier ref the trie holds."""
        out: List[HostPageRef] = []

        def walk(node: _Node):
            if node.host is not None:
                out.append(node.host)
            for tail in node.tails.values():
                out.extend(tail.host or ())
            for child in node.children.values():
                walk(child)

        for root in self.roots.values():
            walk(root)
        return out

    @property
    def host_held_pages(self) -> int:
        """Host-tier pages the trie references (the host pool must hold
        exactly these)."""
        return len(self._host_refs())

    def telemetry_gauges(self):
        """Index-occupancy gauges for the metrics registry
        (``name -> (help, value)``)."""
        return {
            "spa_prefix_held_pages":
                ("device pages held by the index", self.held_pages),
            "spa_prefix_host_held_pages":
                ("host-tier pages referenced by the index",
                 self.host_held_pages),
        }
