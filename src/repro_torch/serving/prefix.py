"""Shared-prefix radix index for the paged serving engine (the JAX
package's ``serving/prefix.py``, device tier only).

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

The host-RAM tier (demotion and promotion of evicted entries) waits for a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.pool import PagePool

TokenRun = Tuple[int, ...]


@dataclasses.dataclass
class _Tail:
    """Full-run completion for a prompt ending at the owning node."""
    pages: List[int]
    last_used: int


@dataclasses.dataclass
class _Node:
    """One logical page of prompt tokens; ``page`` holds its states."""
    page: Optional[int] = None
    last_used: int = 0
    children: Dict[TokenRun, "_Node"] = dataclasses.field(
        default_factory=dict)
    tails: Dict[TokenRun, _Tail] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Lookup result: ``pages`` map logical pages [0, len(pages)) of the
    request's row; ``full`` means the whole row span is covered (skip the
    prefill forward)."""
    pages: Tuple[int, ...]
    full: bool

    @property
    def n_pages(self) -> int:
        return len(self.pages)


class PrefixIndex:
    """Radix trie over page-sized prompt token runs -> physical pages."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.roots: Dict[Tuple, _Node] = {}
        self._clock = 0          # monotonic LRU clock (lookup/insert)

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
               partial_ok: bool = True) -> Optional[PrefixMatch]:
        """Longest page-aligned match for ``prompt`` under the layout root:
        a full-run match when the prompt ends exactly at the matched node
        and a tail entry exists, otherwise the matched prefix pages (None
        when empty or ``partial_ok`` is False)."""
        now = self._tick()
        node = self.roots.get(root_key)
        runs, loose = self._split(prompt)
        pages: List[int] = []
        if node is not None:
            for run in runs:
                child = node.children.get(run)
                if child is None:
                    node = None
                    break
                if child.page is None:
                    node = child
                    break
                child.last_used = now
                pages.append(child.page)
                node = child
            else:
                tail = node.tails.get(loose)
                if tail is not None:
                    tail.last_used = now
                    return PrefixMatch(tuple(pages + tail.pages), True)
        if pages and partial_ok:
            return PrefixMatch(tuple(pages), False)
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
                out.append(depth)
            node = child
        if node is None or loose not in node.tails:
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
                    child.page = page
                else:
                    rejected.append(page)
            child.last_used = now
            node = child
        tail_pages = [p for p in pages[len(runs):] if p is not None]
        if tail_pages:
            if loose in node.tails:
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

    def evict(self, pool: PagePool, n_pages: int) -> int:
        """Free at least ``n_pages`` pages of reader-less entries, least
        recently used first (deepest first by construction).  Returns the
        pages freed: fewer when everything left has readers."""
        freed = 0
        while freed < n_pages:
            units = self._evictable(pool)
            if not units:
                break
            _, kind, node, tail_key = min(units, key=lambda u: u[0])
            if kind == "tail":
                pages = node.tails.pop(tail_key).pages
            else:
                pages = [node.page]
                node.page = None
            pool.release(pages)
            freed += len(pages)
        return freed

    def clear(self, pool: PagePool) -> int:
        """Release every index hold (readers keep theirs) and drop the
        trie.  Returns the number of holds released."""
        pages = self.device_pages()
        pool.release(pages)
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
