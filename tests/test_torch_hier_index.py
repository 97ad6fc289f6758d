"""PyTorch port vs the JAX package: the prefix index's host-tier branches.

Each package's ``PrefixIndex`` with a ``TierManager`` attached, over its own
page pool and host pool, both tiers reading the same fake arenas.  Seeded
sequences of insert (with stability registration), lookup with promotion
(the engine's handshake: ``sites_intact``, ``promote``, ``install_promoted``,
``note_promoted``), reader holds, evict and clear must observe the same
matches (host refs' representation, units, exactness and checksums
included), freed, demoted and dropped counts (the port's ``evict`` reports
them; JAX's index counts them), device and host held pages
and pool refcounts; the host pool must hold exactly the index's refs after
every operation.  Fixed scenarios pin the demote / promote handshake, a
dropped node pruning its host subtree, and an insert superseding host refs.
"""
import zlib

import numpy as np
import pytest
import torch

from repro.serving import hier as jhier
from repro.serving.pool import PagePool as JPool
from repro.serving.prefix import PrefixIndex as JIndex

from _torch_parity import port_cfg
from repro_torch.serving import hier as thier
from repro_torch.serving.pool import PagePool as TPool
from repro_torch.serving.prefix import PrefixIndex as TIndex

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE
N_PAGES = 40
SIG = (16, False, True, "float32")


class Side:
    """One package's index, device pool and tier over fake arenas."""

    def __init__(self, cfg, jax_side, host_pages, host_dtype, seed=0):
        rng = np.random.default_rng(seed)
        self.data = rng.normal(size=(2, N_PAGES, PAGE, 6)).astype(np.float32)
        # page p's identifier rows: parallel (stable) for every third page
        prox = rng.normal(size=(N_PAGES, 1, PAGE, 8)).astype(np.float32)
        prox[::3] = prox[::3, :, :1]
        self.prox = prox
        self.jax = jax_side
        if jax_side:
            self.pool = JPool(cfg, n_pages=N_PAGES, page_size=PAGE)
            self.idx = JIndex(PAGE)
            self.tier = jhier.TierManager(
                jhier.HostPagePool(host_pages), host_dtype=host_dtype,
                read_pages=self._read)
        else:
            self.pool = TPool(port_cfg(cfg), n_pages=N_PAGES, page_size=PAGE,
                              device="cpu")
            self.idx = TIndex(PAGE)
            self.tier = thier.TierManager(
                thier.HostPagePool(host_pages), host_dtype=host_dtype,
                read_pages=self._read)
        self.idx.tier = self.tier
        self.held = []
        self.tally = {"demoted": 0, "dropped": 0, "promoted": 0, "full": 0,
                      "stable": 0}

    def evict(self, n):
        """``evict``'s freed, demoted and dropped pages and the drops the
        tier refused as full / as stable (JAX's split read off its index's
        and its tier manager's counters), added to the tally."""
        if self.jax:
            d0, x0 = self.idx.demoted_pages, self.idx.dropped_pages
            f0, s0 = self.tier.dropped_full, self.tier.dropped_stable
            freed = self.idx.evict(self.pool, n)
            out = (freed, self.idx.demoted_pages - d0,
                   self.idx.dropped_pages - x0,
                   self.tier.dropped_full - f0,
                   self.tier.dropped_stable - s0)
        else:
            out = tuple(self.idx.evict(self.pool, n))
        self.tally["demoted"] += out[1]
        self.tally["dropped"] += out[2]
        self.tally["full"] += out[3]
        self.tally["stable"] += out[4]
        return out

    def _read(self, sig, pages):
        k, v = self.data[:, pages], 3.0 * self.data[:, pages]
        if not self.jax:
            k, v = torch.from_numpy(k), torch.from_numpy(v)
        return {"kv": {"k": k, "v": v}}

    def publish(self, pages):
        blocks = {p: self.prox[p] for p in pages}
        if not self.jax:
            blocks = {p: torch.from_numpy(b) for p, b in blocks.items()}
        self.tier.note_published(SIG, pages, blocks)

    def check(self):
        assert self.tier.host.used_pages == self.idx.host_held_pages
        assert self.pool.used == len(self.pool.refcounts)


def _refs(m):
    return tuple((r.repr_, r.units, r.exact, r.checksum)
                 for r in m.host_refs)


def _apply(side, op):
    """Apply one op; returns what it observed."""
    kind, root, prompt, n, partial_ok = op
    idx, pool = side.idx, side.pool
    n_run = root[0] // PAGE
    if kind == "insert":
        slots = (idx.missing_slots(root, prompt, n_run) if n % 2
                 else list(range(n_run)))
        pages = pool.alloc(len(slots)) if slots else []
        if pages is None:
            return ("insert-short", slots)
        run = [None] * n_run
        for d, p in zip(slots, pages):
            run[d] = p
        rejected = idx.insert(root, prompt, run)
        pool.release(rejected)
        side.publish([p for p in pages if p not in rejected])
        return ("insert", slots, sorted(rejected))
    if kind in ("lookup", "hold"):
        m = idx.lookup(root, prompt, partial_ok=partial_ok)
        if m is None:
            return (kind, None)
        out = (tuple(m.pages), m.full, m.exact, _refs(m))
        pages = list(m.pages)
        if m.needs_promotion:
            assert idx.sites_intact(m)
            new = pool.alloc(len(m.host_refs))
            if new is None:
                return (kind, out, "stall")
            refs = list(m.host_refs)
            sig, blocks = side.tier.promote(refs)
            k = np.ascontiguousarray(np.asarray(blocks["kv"]["k"],
                                                np.float32))
            pages = idx.install_promoted(m, new)
            side.tally["promoted"] += len(new)
            side.tier.note_promoted(sig, new, refs)
            assert not idx.sites_intact(m)
            out += ("promoted", new, zlib.crc32(k.tobytes()))
        if kind == "hold":
            pool.retain(pages)
            side.held.append(pages)
        return (kind, out)
    if kind == "release":
        if side.held:
            pool.release(side.held.pop(0))
        return ("release", len(side.held))
    if kind == "evict":
        return ("evict",) + side.evict(n) + (side.tally["demoted"],
                                             side.tally["dropped"])
    return ("clear", idx.clear(pool))


def _ops(rng, n_ops):
    stems = [rng.integers(0, 6, int(rng.integers(4, 14))).astype(np.int32)
             for _ in range(5)]
    ops = []
    for _ in range(n_ops):
        stem = stems[int(rng.integers(0, len(stems)))]
        cut = int(rng.choice([len(stem), len(stem), 8,
                              int(rng.integers(1, len(stem) + 1))]))
        prompt = stem[:cut]
        root = (CANVAS, "spec") if rng.random() < 0.8 else (2 * CANVAS, "x")
        kind = rng.choice(["insert", "lookup", "hold", "release", "evict",
                           "clear"], p=[.3, .25, .12, .1, .21, .02])
        ops.append((str(kind), root, prompt, int(rng.integers(1, 7)),
                    bool(rng.random() < 0.7)))
    return ops


@pytest.mark.parametrize("host_dtype", ["f32", "auto", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_tiered_index_matches_jax(tiny_cfg, seed, host_dtype):
    ops = _ops(np.random.default_rng(seed), 150)
    host_pages = 6 + 4 * seed
    jside = Side(tiny_cfg, True, host_pages, host_dtype)
    tside = Side(tiny_cfg, False, host_pages, host_dtype)
    seen = []
    for i, op in enumerate(ops):
        got, want = _apply(tside, op), _apply(jside, op)
        seen.append(got)
        assert got == want, (i, op[0], got, want)
        assert sorted(tside.idx.device_pages()) == sorted(
            jside.idx.device_pages())
        assert tside.idx.held_pages == jside.idx.held_pages
        assert tside.idx.host_held_pages == jside.idx.host_held_pages
        assert tside.pool.refcounts == jside.pool.refcounts
        assert tside.tier.host.used_units == jside.tier.host.used_units
        tside.check()
        jside.check()
    assert tside.tally["demoted"] > 0 and tside.tally["promoted"] > 0
    assert any(s[0] in ("lookup", "hold") and s[1] is not None
               and len(s[1]) > 4 for s in seen)         # promotions ran
    assert tside.tally == jside.tally
    assert jside.tally == {"demoted": jside.idx.demoted_pages,
                           "dropped": jside.idx.dropped_pages,
                           "promoted": jside.idx.promoted_pages,
                           "full": jside.tier.dropped_full,
                           "stable": jside.tier.dropped_stable}


def _both(tiny_cfg, host_pages, host_dtype="f32"):
    return (Side(tiny_cfg, True, host_pages, host_dtype),
            Side(tiny_cfg, False, host_pages, host_dtype))


def _insert_run(side, prompt, root=(CANVAS, "spec")):
    pages = side.pool.alloc(root[0] // PAGE)
    assert not side.idx.insert(root, prompt, pages)
    side.publish(pages)
    return pages


def test_demote_promote_handshake_matches_jax(tiny_cfg):
    """A whole run demoted (it stays in the trie), looked up as a full hit
    that needs promotion, promoted bit-exact into fresh pages."""
    key, prompt = (CANVAS, "spec"), np.arange(10, dtype=np.int32)
    for side in _both(tiny_cfg, 8):
        pages = _insert_run(side, prompt)
        assert side.evict(N_LOG) == (N_LOG, N_LOG, 0, 0, 0)
        assert side.pool.used == 0 and side.idx.held_pages == 0
        assert side.idx.host_held_pages == N_LOG == side.tier.host.used_pages
        m = side.idx.lookup(key, prompt)
        assert m.full and m.needs_promotion and m.exact
        assert m.n_pages == N_LOG and side.idx.sites_intact(m)
        sig, blocks = side.tier.promote(list(m.host_refs))
        assert sig == SIG
        np.testing.assert_array_equal(np.asarray(blocks["kv"]["k"]),
                                      side.data[:, pages])
        new = side.pool.alloc(N_LOG)
        assert side.idx.install_promoted(m, new) == new
        assert side.idx.host_held_pages == 0 == side.tier.host.used_pages
        m2 = side.idx.lookup(key, prompt)
        assert m2.full and not m2.needs_promotion and list(m2.pages) == new


def test_dropped_node_prunes_its_host_subtree(tiny_cfg):
    """The tail demotes and fills the host budget; its node cannot demote,
    so it drops, and the tail's host refs below it are freed with it (2
    pruned + 1 dropped); the first path page then demotes into the room
    the prune made."""
    out = []
    for side in _both(tiny_cfg, 2):              # room for the 2-page tail
        prompt = np.arange(8, dtype=np.int32)    # 2 path pages + 2 tail
        _insert_run(side, prompt)
        freed, demoted, dropped, full, stable = side.evict(N_LOG)
        m = side.idx.lookup((CANVAS, "spec"), prompt)
        out.append((freed, demoted, dropped, full, stable,
                    side.idx.host_held_pages, side.tier.host.used_pages,
                    m.full, len(m.host_refs)))
    assert out[0] == out[1] == (4, 3, 3, 1, 0, 1, 1, False, 1)


def test_insert_supersedes_host_refs(tiny_cfg):
    """A fresh publication over a demoted entry frees its host refs and
    takes the device pages."""
    key, prompt = (CANVAS, "spec"), np.arange(10, dtype=np.int32)
    out = []
    for side in _both(tiny_cfg, 8):
        _insert_run(side, prompt)
        side.evict(N_LOG)
        assert side.idx.missing_slots(key, prompt, N_LOG) == list(
            range(N_LOG))
        fresh = _insert_run(side, prompt)
        m = side.idx.lookup(key, prompt)
        out.append((list(m.pages), m.full, side.idx.host_held_pages,
                    side.tier.host.used_pages))
        assert list(m.pages) == fresh and not m.needs_promotion
        side.idx.clear(side.pool)
        assert side.pool.used == 0 and side.tier.host.used_pages == 0
    assert out[0] == out[1] and out[1][2:] == (0, 0)
