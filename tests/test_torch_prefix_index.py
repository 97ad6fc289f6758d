"""PyTorch port vs the JAX package: the shared-prefix building blocks.

1. ``PrefixIndex`` (device tier) against the JAX index on the same seeded
   sequences of insert, lookup, reader holds, evict and clear over one
   page pool each: the same matches, rejected pages, freed counts, held
   pages and pool refcounts after every operation.
2. ``core.cache.copy_arena_pages`` against the JAX function on every
   buffer of a cache's arenas, overlapping source and target included.
3. ``decoding.prefill_partial`` against the JAX function per strategy
   (singular, value, attn_in; also incremental singular): the suffix rows
   within 1e-5 of JAX's, exact zeros below the suffix start, and within
   1e-5 of the port's own cold prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import strategy as jstrategy
from repro.dlm import decoding as jdecoding
from repro.serving.pool import PagePool as JPool
from repro.serving.prefix import PrefixIndex as JIndex

from _torch_parity import np32, port_cfg, port_params, port_proxies
from repro_torch.core import cache as tcache
from repro_torch.core import strategy as tstrategy
from repro_torch.dlm import decoding as tdecoding
from repro_torch.serving.pool import PagePool as TPool
from repro_torch.serving.prefix import PrefixIndex as TIndex

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE


def _index_ops(rng, n_ops):
    """A seeded op sequence over a small token alphabet, so that prompts
    share prefixes, repeat and extend each other."""
    stems = [rng.integers(0, 6, int(rng.integers(4, 14))).astype(np.int32)
             for _ in range(5)]
    ops = []
    for _ in range(n_ops):
        stem = stems[int(rng.integers(0, len(stems)))]
        cut = int(rng.choice([len(stem), len(stem), 8,
                              int(rng.integers(1, len(stem) + 1))]))
        extra = int(rng.integers(1, 3)) if rng.random() < 0.3 else 0
        prompt = np.concatenate([stem[:cut], rng.integers(
            0, 6, extra).astype(np.int32)])
        root = (CANVAS, "spec") if rng.random() < 0.8 else (2 * CANVAS, "x")
        kind = rng.choice(["insert", "lookup", "lookup", "hold", "release",
                           "evict", "clear"], p=[.3, .25, .1, .1, .1, .12,
                                                 .03])
        ops.append((str(kind), root, prompt, int(rng.integers(1, 6)),
                    bool(rng.random() < 0.7)))
    return ops


def _apply(idx, pool, held, op):
    """Apply one op to an index and its pool; returns what it observed."""
    kind, root, prompt, n, partial_ok = op
    n_run = root[0] // PAGE
    if kind == "insert":    # the engine's probe first, or a whole run
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
        return ("insert", slots, sorted(rejected))
    if kind in ("lookup", "hold"):
        m = idx.lookup(root, prompt, partial_ok=partial_ok)
        out = None if m is None else (tuple(m.pages), m.full)
        if kind == "hold" and m is not None:
            pool.retain(list(m.pages))
            held.append(list(m.pages))
        return (kind, out)
    if kind == "release":
        if held:
            pool.release(held.pop(0))
        return ("release", len(held))
    if kind == "evict":
        bound = idx.evictable_total(pool)
        freed = idx.evict(pool, n)
        if isinstance(freed, tuple):     # the port's Eviction, no tier:
            assert freed.demoted == 0 and freed.dropped == freed.freed
            freed = freed.freed
        return ("evict", bound, freed)
    return ("clear", idx.clear(pool))


@pytest.mark.parametrize("seed", range(6))
def test_prefix_index_matches_jax(tiny_cfg, seed):
    ops = _index_ops(np.random.default_rng(seed), 120)
    jpool = JPool(tiny_cfg, n_pages=40, page_size=PAGE)
    tpool = TPool(port_cfg(tiny_cfg), n_pages=40, page_size=PAGE,
                  device="cpu")
    jidx, tidx = JIndex(PAGE), TIndex(PAGE)
    jheld, theld = [], []
    kinds, seen = set(), []
    for i, op in enumerate(ops):
        got = _apply(tidx, tpool, theld, op)
        want = _apply(jidx, jpool, jheld, op)
        seen.append(got)
        assert got == want, (i, op[0], got, want)
        assert sorted(tidx.device_pages()) == sorted(jidx.device_pages())
        assert tidx.held_pages == jidx.held_pages
        assert tpool.refcounts == jpool.refcounts
        kinds.add(got[0] if got[0] not in ("lookup", "hold")
                  or got[1] is None
                  else ("full" if got[1][1] else "partial"))
    assert {"insert", "full", "partial", "evict"} <= kinds
    assert any(r[0] == "insert" and r[2] for r in seen)   # rejections


def test_copy_arena_pages_matches_jax(tiny_cfg):
    """Every buffer of an incremental singular cache's arenas; pages copied
    onto each other in a chain (an overlap of source and target)."""
    cfg = tiny_cfg
    strat = jstrategy.SPACache(rank=16, incremental_ident=True)
    rng = np.random.default_rng(0)
    arenas = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jcache.init_paged_arenas(cfg, 9, PAGE, strat))
    tarenas = {kind: {nm: torch.from_numpy(np32(a).copy())
                      for nm, a in bufs.items()}
               for kind, bufs in arenas.items()}
    for src, dst in (([1, 2, 3], [5, 6, 7]), ([4, 5], [5, 8]), ([], [])):
        arenas = jcache.copy_arena_pages(arenas, src, dst)
        assert tcache.copy_arena_pages(tarenas, src, dst) is tarenas
        for kind, bufs in arenas.items():
            for nm, a in bufs.items():
                np.testing.assert_array_equal(tarenas[kind][nm].numpy(),
                                              np32(a), err_msg=nm)


def _strategies(name):
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    if name in ("singular", "singular+inc"):
        inc = name.endswith("+inc")
        return (jstrategy.SPACache(**spec, incremental_ident=inc),
                tstrategy.SPACache(**spec, incremental_ident=inc))
    return (jstrategy.ValueProxyCache(projection=name, rho=0.3),
            tstrategy.ValueProxyCache(projection=name, rho=0.3))


@pytest.mark.parametrize("name", ["singular", "singular+inc", "value",
                                  "attn_in"])
def test_prefill_partial_matches_jax(tiny_cfg, tiny_params, name):
    """The suffix-only prefill over the cold prefill's prefix K/V, at
    suffix starts 4 and 8, kv_len 16 and 12."""
    cfg, params = tiny_cfg, tiny_params
    jstrat, tstrat = _strategies(name)
    tcfg = port_cfg(cfg)
    jprox = jstrat.build_proxies(params, cfg)
    tprox = port_proxies(jprox, tcfg) if jprox is not None else None
    tparams = port_params(params, tcfg)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size - 1, (2, CANVAS)).astype(np.int32)
    kv = np.asarray([CANVAS, 12], np.int32)
    _, jcold = jdecoding.prefill(params, cfg, {"tokens": jnp.asarray(toks)},
                                 jprox, jstrat, kv_len=jnp.asarray(kv))
    _, tcold = tdecoding.prefill(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)}, tprox,
                                 tstrat, kv_len=torch.from_numpy(kv))
    for s0 in (4, 8):
        jview = {kind: {nm: bufs[nm] for nm in ("k", "v")}
                 for kind, bufs in jcold.items()}
        # the port reads the JAX cold prefill's prefix K/V: both sides
        # start from the same bits
        tview = {kind: {nm: torch.from_numpy(np32(a).copy())
                        for nm, a in bufs.items()}
                 for kind, bufs in jview.items()}
        jpart = jdecoding.prefill_partial(
            params, cfg, {"tokens": jnp.asarray(toks)}, jview, s0,
            kv_len=jnp.asarray(kv), spa_proxies=jprox, strategy=jstrat)
        tpart = tdecoding.prefill_partial(
            tparams, tcfg, {"tokens": torch.from_numpy(toks)}, tview, s0,
            kv_len=torch.from_numpy(kv), spa_proxies=tprox, strategy=tstrat)
        assert sorted(tpart) == sorted(jpart)
        for kind, bufs in jpart.items():
            assert sorted(tpart[kind]) == sorted(bufs)
            for nm, a in bufs.items():
                got = tpart[kind][nm].numpy()
                assert not got[:, :, :s0].any(), nm
                np.testing.assert_allclose(got[:, :, s0:],
                                           np32(a)[:, :, s0:], rtol=1e-5,
                                           atol=1e-5, err_msg=f"{s0} {nm}")
                np.testing.assert_allclose(
                    got[:, :, s0:], tcold[kind][nm].numpy()[:, :, s0:],
                    rtol=1e-5, atol=1e-5, err_msg=f"cold {s0} {nm}")


def test_partial_prefill_supported_matches_jax():
    from repro.configs import get_arch, reduced
    from repro_torch import configs as tconfigs
    for arch in ("llada-8b", "internlm2-1.8b", "recurrentgemma-9b",
                 "mamba2-370m"):
        cfg = reduced(get_arch(arch))
        assert tdecoding.partial_prefill_supported(
            tconfigs.reduced(tconfigs.get_arch(arch))) == \
            jdecoding.partial_prefill_supported(cfg), arch
