"""PyTorch port vs the JAX package: the serving engine with the host-RAM
page tier.

Both engines serve the JAX serving benchmark's host-tier traffic
(``benchmarks/bench_serving.py:_hier_workload``: 8 distinct mixed-size
requests in waves of 2, a warm pass then a measured pass, pool 15 pages of
4, canvas 32, host budget the prefix set's pages) with the same weights and
singular proxies.  With the tier off and on at f32, int8 and auto: the same
outputs and every engine, prefix and tier counter, the pools drained to the
index's holds and the host pool to its refs.  The tier raises full hits
over the tier off; an f32 promotion writes back bit for bit what its
demotion read; a corrupted host slot is served by a cold prefill as in the
JAX engine, and both tiers end with no leak.
"""
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache

from _torch_parity import assert_engines_match, engine_pair, np32
from repro_torch.core.strategy import SPACache as TSPACache

torch.set_num_threads(1)
PAGE, CANVAS, POOL = 4, 32, 15
_RUNS = {}


@pytest.fixture(scope="module")
def bench_model():
    import jax
    from repro.configs import get_arch, reduced
    from repro.models import transformer
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256)
    return cfg, transformer.init_params(cfg, jax.random.PRNGKey(0))


def _workload(cfg, n_reqs=8):
    """The JAX bench's ``_hier_workload``: prompt 4-11 tokens, gen 4-16,
    from seed 29."""
    rng = np.random.default_rng(29)
    out = []
    for _ in range(n_reqs):
        p_len = int(rng.integers(4, 12))
        gen = int(rng.integers(4, 17))
        out.append((rng.integers(0, cfg.vocab_size - 1,
                                 p_len).astype(np.int32), gen))
    return out


def _waves(eng, reqs):
    for i in range(0, len(reqs), 2):
        for prompt, gen in reqs[i:i + 2]:
            eng.submit(prompt, gen)
        eng.run()


def _reset(eng):
    eng.done.clear()
    eng.stats = type(eng.stats)()
    eng.pool.reset_telemetry()
    if eng.host_pool is not None:
        eng.host_pool.reset_telemetry()


def _pair(cfg, params, host_dtype):
    reqs = _workload(cfg)
    host_pages = sum(-(-(len(p) + g) // PAGE) for p, g in reqs)
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    return reqs, engine_pair(
        cfg, params, (JSPACache(**spec), TSPACache(**spec)), max_batch=2,
        canvas_len=CANVAS, pool_pages=POOL, page_size=PAGE,
        prefix_cache=True, host_pages=host_pages if host_dtype else 0,
        host_dtype=host_dtype or "auto")


def _served(cfg, params, host_dtype):
    """Both engines after the warm and the measured pass (cached)."""
    if host_dtype not in _RUNS:
        reqs, (jeng, teng) = _pair(cfg, params, host_dtype)
        for eng in (jeng, teng):
            _waves(eng, reqs)
            _reset(eng)
            _waves(eng, reqs)
        _RUNS[host_dtype] = (jeng, teng)
    return _RUNS[host_dtype]


@pytest.mark.parametrize("host_dtype", [None, "f32", "int8", "auto"])
def test_tier_engine_matches_jax(bench_model, host_dtype):
    jeng, teng = _served(*bench_model, host_dtype)
    assert_engines_match(jeng, teng)
    assert teng.stats.requests_done == 8
    if host_dtype is None:
        assert teng.host_pool is None
        assert teng.stats.prefix_evicted_pages > 0
        return
    assert teng.stats.prefix_demoted_pages > 0
    assert teng.stats.prefix_promotions > 0
    assert teng.host_pool.used_pages == teng.prefix.host_held_pages


def test_tier_raises_full_hits(bench_model):
    off = _served(*bench_model, None)[1].stats
    on = _served(*bench_model, "f32")[1].stats
    assert on.prefix_full_hits > off.prefix_full_hits
    assert on.prefix_promoted_pages > 0 and on.prefix_dropped_pages == 0


def test_f32_promotion_is_bit_identical(bench_model):
    """Every page an f32 promotion writes equals, bit for bit, what the
    demotion read from the arenas."""
    cfg, params = bench_model
    reqs, (_, teng) = _pair(cfg, params, "f32")
    tier = teng.tier
    read, demote, promote = tier.read_pages, tier.demote, tier.promote
    last, saved, checked = {}, {}, []

    def read_pages(sig, pages):
        blocks = read(sig, pages)
        last["blocks"] = {k: {n: t.clone() for n, t in b.items()}
                          for k, b in blocks.items()}
        return blocks

    def demote_(pages, exact_in=True):
        refs = demote(pages, exact_in)
        for i, r in enumerate(refs or ()):
            saved[r] = {k: {n: t[:, i] for n, t in b.items()}
                        for k, b in last["blocks"].items()}
        return refs

    def promote_(refs):
        sig, blocks = promote(refs)
        for i, r in enumerate(refs):
            for kind, bufs in saved.pop(r).items():
                for name, want in bufs.items():
                    assert torch.equal(blocks[kind][name][:, i], want)
                    checked.append(name)
        return sig, blocks

    tier.read_pages, tier.demote, tier.promote = read_pages, demote_, promote_
    _waves(teng, reqs)
    _waves(teng, reqs)
    assert checked and teng.stats.prefix_promoted_pages > 0


def _jax_host_refs(idx):
    out = []

    def walk(node):
        if node.host is not None:
            out.append(node.host)
        for tail in node.tails.values():
            out.extend(tail.host or ())
        for child in node.children.values():
            walk(child)

    for root in idx.roots.values():
        walk(root)
    return out


def test_corrupt_slot_is_served_cold_without_leaks(bench_model):
    """After the warm pass every host slot the index refers to has its
    first bytes flipped, in both engines: each promotion raises on its
    checksum and is served cold, as in the JAX engine (pages demoted later
    in the pass promote as usual), and afterwards both tiers hold exactly
    what the index refers to."""
    cfg, params = bench_model
    reqs, (jeng, teng) = _pair(cfg, params, "f32")
    for eng, refs in ((jeng, _jax_host_refs), (teng,
                                               lambda i: i._host_refs())):
        _waves(eng, reqs)
        _reset(eng)
        held = refs(eng.prefix)
        assert held
        for r in held:
            eng.host_pool.corrupt_slot(r.sig, r.repr_, r.slot)
        _waves(eng, reqs)
    assert_engines_match(jeng, teng)
    stats = teng.stats
    assert stats.host_checksum_failures > 0
    assert stats.cold_prefill_fallbacks == stats.host_checksum_failures
    assert teng.pool.used == teng.prefix.held_pages
    assert teng.host_pool.used_pages == teng.prefix.host_held_pages
    assert teng.drop_prefix_cache() > 0
    assert teng.pool.used == 0 and teng.host_pool.used_pages == 0
    assert teng.host_pool.used_units == 0
    jeng.drop_prefix_cache()
    assert jeng.host_pool.used_pages == 0


_TIER_KEYS = ("demoted_pages", "promoted_pages", "dropped_full",
              "dropped_stable", "store_faults", "checksum_failures")


def test_tier_counters_and_debug_state_match_jax(bench_model):
    """A host tier of two pages under the bench traffic, every host slot
    corrupted and the statistics reset between the two passes (as the JAX
    bench resets after its warm pass): the port engine's
    ``pool_debug_state`` reports the JAX tier manager's lifetime counters
    (demoted, promoted, dropped for want of room, corrupt pages, not
    promotions) and the JAX host pool's pages in / out since the reset,
    with the JAX keys."""
    cfg, params = bench_model
    reqs = _workload(cfg)
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    jeng, teng = engine_pair(
        cfg, params, (JSPACache(**spec), TSPACache(**spec)), max_batch=2,
        canvas_len=CANVAS, pool_pages=POOL, page_size=PAGE,
        prefix_cache=True, host_pages=2, host_dtype="auto")
    for eng, refs in ((jeng, _jax_host_refs), (teng,
                                               lambda i: i._host_refs())):
        _waves(eng, reqs)
        for r in refs(eng.prefix):
            eng.host_pool.corrupt_slot(r.sig, r.repr_, r.slot)
        _reset(eng)
        _waves(eng, reqs)
    assert_engines_match(jeng, teng)
    view = teng.pool_debug_state()
    want = {name: getattr(jeng.tier, name) for name in _TIER_KEYS}
    assert view["tier"] == want
    assert want == {"demoted_pages": 4, "promoted_pages": 2,
                    "dropped_full": 2, "dropped_stable": 0,
                    "store_faults": 0, "checksum_failures": 2}
    assert teng.stats.host_checksum_failures == 1   # one entry of 2 pages
    jhost = jeng.host_pool.debug_state()
    assert set(view["host_pool"]) == set(jhost)
    for key in ("unit_budget", "units_used", "peak_units", "resident_pages",
                "pages_in", "pages_out"):
        assert view["host_pool"][key] == jhost[key], key


def test_promoted_pages_decode_like_the_publisher(bench_model):
    """The measured f32 pass: a request whose full hit was promoted from the
    host tier decodes the tokens its own warm-pass run decoded."""
    cfg, params = bench_model
    reqs, (_, teng) = _pair(cfg, params, "f32")
    _waves(teng, reqs)
    first = {r.uid: np32(r.output) for r in teng.done}
    _reset(teng)
    _waves(teng, reqs)
    assert teng.stats.prefix_promotions > 0
    for r in teng.done:
        np.testing.assert_array_equal(np32(r.output), first[r.uid - 8])


@pytest.mark.parametrize("host_dtype", ["f32", "auto"])
def test_serve_cli_prints_the_tier_line(capsys, host_dtype):
    """The offline launcher with ``--host-pages``: on a pool of 16 the
    repeats evict the index's 6 pages to the host tier and the last repeat
    promotes them back (the JAX launcher's tier counters read the same)."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                        "--requests", "8", "--gen-len", "6", "--canvas",
                        "24", "--max-batch", "2", "--pool-pages", "16",
                        "--page-size", "4", "--host-pages", "12",
                        "--host-dtype", host_dtype]) == 0
    out = capsys.readouterr().out
    assert ("tier: 6 pages demoted, 0 dropped, 6 promoted in 1 promotions "
            "(0 stalls), 0 held; host peak 50.0% of 24 units "
            f"({host_dtype})") in out
