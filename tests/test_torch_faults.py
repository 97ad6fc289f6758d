"""PyTorch port vs the JAX package: fault injection's pieces.

``serving/faults.py`` of both packages: plan validation, probe determinism
and the injector's fire log on the same probe sequences, ``_hash01`` and
``choose_index`` bit for bit over a grid of (seed, site, probe),
``corrupt_array`` on a slot of the host tier's layout; the seams: the
pool's ``fault_hook``, the tier's ``host_store`` refusal and
``host_corrupt`` bit flip against JAX's ``TierManager``, the index's
``demote_paused``; the session's NaN poisoning (float buffers only, applied
after the step's refresh, caught by ``row_finite``); the engine accepting
the fault arguments; and ``serve --supervise --chaos-seed`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro.serving import hier as jhier
from repro.serving.pool import PagePool as JPool
from repro.serving.prefix import PrefixIndex as JIndex

from _torch_parity import port_cfg
from repro_torch.launch import serve as tserve
from repro_torch.serving import faults as tfaults
from repro_torch.serving import hier as thier
from repro_torch.serving.pool import PagePool as TPool
from repro_torch.serving.prefix import PrefixIndex as TIndex

torch.set_num_threads(1)
PAGE = 4
SIG = (16, True, True, "float32")


# ---------------------------------------------------------------------------
# FaultPlan / FaultInjector
# ---------------------------------------------------------------------------

def test_fault_plan_validation_and_probe_determinism():
    """The JAX unit test, through both packages' injectors: the same fires,
    the same logs, ``max_fires`` capping a storm, sticky stalls."""
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match="bogus_site"):
            mod.FaultPlan(rates={"bogus_site": 0.5})
    spec = dict(seed=3, at={"pool_alloc": (1, 4)}, rates={"step_nan": 0.5},
                max_fires={"step_nan": 2})
    logs = []
    for mod in (jfaults, tfaults, tfaults):
        inj = mod.FaultInjector(mod.FaultPlan(**spec))
        hits = [inj.fire("pool_alloc") for _ in range(6)]
        assert [i for i, h in enumerate(hits) if h] == [1, 4]
        for _ in range(64):
            inj.fire("step_nan")
        assert inj.fired["step_nan"] == 2
        assert inj.total_fired == 4
        logs.append(inj.log)
    assert logs[0] == logs[1] == logs[2]
    inj = tfaults.FaultInjector(tfaults.FaultPlan(at={"lane_stall": (0,)}))
    lane = object()
    assert inj.stall_lane(lane) and inj.stall_lane(lane)  # sticky
    assert inj.fired["lane_stall"] == 1
    inj.clear_stall(lane)
    assert not inj.stall_lane(lane)


def test_plan_is_a_frozen_copy():
    rates = {"step_nan": 0.1}
    plan = tfaults.FaultPlan(rates=rates, at={"disconnect": [2, 3]})
    rates["step_nan"] = 0.9
    assert plan.rates == {"step_nan": 0.1}
    assert plan.at == {"disconnect": (2, 3)}
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.seed = 1


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2 ** 31 - 1])
def test_hash01_and_choose_index_match_jax(seed):
    """Bit for bit: the port's draws equal JAX's for every (seed, site,
    probe) of the grid, and so do the picks of ``choose_index``."""
    for site in tfaults.FAULT_SITES + ("nan_row",):
        for k in range(64):
            assert tfaults._hash01(seed, site, k) == \
                jfaults._hash01(seed, site, k)
            for n in (1, 2, 3, 4, 7):
                assert tfaults.choose_index(seed, site, k, n) == \
                    jfaults.choose_index(seed, site, k, n)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_storm_fires_like_jax(seed):
    """A storm over every site: the same fire log as JAX's injector over
    a few hundred probes in an interleaved order."""
    rates = {s: 0.1 for s in tfaults.FAULT_SITES}
    j = jfaults.FaultInjector(jfaults.FaultPlan(seed=seed, rates=rates))
    t = tfaults.FaultInjector(tfaults.FaultPlan(seed=seed, rates=rates))
    order = np.random.default_rng(seed).integers(0, 6, 400)
    for i in order:
        site = tfaults.FAULT_SITES[i]
        assert t.fire(site) == j.fire(site)
    assert t.log == j.log and t.fired == j.fired and len(t.log) > 10


def test_corrupt_array_on_a_host_slot():
    """``corrupt_array`` flips the first 8 bytes of a slot of the host
    tier's ``[slots, Lk, page, ...]`` layout (a view, written in place),
    leaves every other byte alone and breaks the slot's checksum; numpy
    arrays too, as the JAX injector's."""
    inj = tfaults.FaultInjector(tfaults.FaultPlan())
    arena = torch.randn(4, 2, PAGE, 6)
    before = arena.clone()
    ck = thier._blocks_checksum({"kv": {"k": arena[1]}})
    inj.corrupt_array(arena[1])
    flat_b = before[1].reshape(-1).view(torch.uint8)
    flat_a = arena[1].reshape(-1).view(torch.uint8)
    assert torch.equal(flat_a[:8], flat_b[:8] ^ 0xFF)
    assert torch.equal(flat_a[8:], flat_b[8:])
    for s in (0, 2, 3):
        assert torch.equal(arena[s], before[s])
    assert thier._blocks_checksum({"kv": {"k": arena[1]}}) != ck
    x = np.ones((4, 4), np.float32)
    y = x.copy()
    inj.corrupt_array(y)
    jy = x.copy()
    jfaults.FaultInjector(jfaults.FaultPlan()).corrupt_array(jy)
    assert not np.array_equal(x, y) and np.array_equal(y.view(np.uint8),
                                                      jy.view(np.uint8))


# ---------------------------------------------------------------------------
# seams
# ---------------------------------------------------------------------------

def test_pool_fault_hook_matches_jax(tiny_cfg):
    """``alloc`` probes ``pool_alloc`` once a non-empty allocation that
    fits, and fails on a fire with the None of a full pool; both pools
    probe alike."""
    plan = dict(at={"pool_alloc": (1, 2)})
    jpool = JPool(tiny_cfg, n_pages=8, page_size=PAGE)
    tpool = TPool(port_cfg(tiny_cfg), n_pages=8, page_size=PAGE,
                  device="cpu")
    jpool.fault_hook = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    tpool.fault_hook = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    for n in (2, 0, 2, 9, 2, 2):
        assert tpool.alloc(n) == jpool.alloc(n)
    assert tpool.fault_hook.log == jpool.fault_hook.log == [
        ("pool_alloc", 1), ("pool_alloc", 2)]
    assert tpool.refcounts == jpool.refcounts


def _tiers(n_host, plan, n_pages=16):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, n_pages, PAGE, 6)).astype(np.float32)
    tdata = torch.from_numpy(data)
    jt = jhier.TierManager(jhier.HostPagePool(n_host), host_dtype="f32",
                           read_pages=lambda sig, p: {"kv": {
                               "k": data[:, p], "v": 2.0 * data[:, p]}})
    tt = thier.TierManager(thier.HostPagePool(n_host), host_dtype="f32",
                           read_pages=lambda sig, p: {"kv": {
                               "k": tdata[:, p], "v": 2.0 * tdata[:, p]}})
    jt.injector = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    tt.injector = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    return jt, tt


def test_tier_store_refusal_and_corruption_match_jax():
    """``demote`` probes ``host_store`` after the room check (a fire
    refuses the unit: ``refusal`` "store", nothing stored, the pages'
    signatures kept for the caller to forget) and ``host_corrupt`` after
    storing (a fire flips the unit's first slot, which the promotion
    checksum catches, freeing the whole entry)."""
    jt, tt = _tiers(8, dict(at={"host_store": (0,), "host_corrupt": (1,)}))
    for t in (jt, tt):
        t.note_published(SIG, [1, 2, 3, 4, 5, 6], None)
    assert tt.demote([1, 2]) is None and jt.demote([1, 2]) is None
    assert tt.refusal == "store" and jt.store_faults == 1
    assert tt.host.used_units == jt.host.used_units == 0
    clean_t, clean_j = tt.demote([3, 4]), jt.demote([3, 4])
    bad_t, bad_j = tt.demote([5, 6]), jt.demote([5, 6])
    assert tt.refusal is None
    assert [r.checksum for r in bad_t] == [r.checksum for r in bad_j]
    assert tt.injector.log == jt.injector.log == [
        ("host_store", 0), ("host_corrupt", 1)]
    for refs, t in ((clean_t, tt), (clean_j, jt)):
        t.promote(list(refs))                # intact: promotes
    with pytest.raises(jhier.HostPageCorruption):
        jt.promote(list(bad_j))
    with pytest.raises(thier.HostPageCorruption) as err:
        tt.promote(list(bad_t))
    assert err.value.bad == jt.checksum_failures == 1
    assert tt.host.used_pages == jt.host.used_pages == 0


def test_tier_store_refusal_drops_as_full_in_the_index(tiny_cfg):
    """A refused store drops the victim, counted with the full-tier drops
    (as JAX's ``dropped_full``); ``demote_paused`` drops every victim
    without a demotion probe."""
    plan = dict(at={"host_store": (0,)})
    jt, tt = _tiers(16, plan, n_pages=40)
    sides = []
    for tier, Pool, Index, cfg in ((jt, JPool, JIndex, tiny_cfg),
                                   (tt, TPool, TIndex, port_cfg(tiny_cfg))):
        pool = (Pool(cfg, n_pages=40, page_size=PAGE)
                if Pool is JPool else Pool(cfg, n_pages=40, page_size=PAGE,
                                           device="cpu"))
        idx = Index(PAGE)
        idx.tier = tier
        for i in range(3):
            prompt = np.arange(10, dtype=np.int32) + 16 * i
            pages = pool.alloc(4)
            idx.insert((16, "spec"), prompt, pages)
            tier.note_published(SIG, pages, None)
        sides.append((pool, idx, tier))
    (jpool, jidx, jt), (tpool, tidx, tt) = sides
    d0 = jidx.dropped_pages
    ev = tidx.evict(tpool, 1)
    jidx.evict(jpool, 1)
    assert ev.dropped_full == jt.dropped_full == ev.dropped == \
        jidx.dropped_pages - d0 > 0
    assert ev.demoted == 0 and jt.store_faults == 1
    tidx.demote_paused = jidx.demote_paused = True
    probes = tt.injector._probes["host_store"]
    ev = tidx.evict(tpool, 40)
    jidx.evict(jpool, 40)
    assert ev.demoted == 0 and ev.dropped_full == 0 and ev.dropped > 0
    assert tt.injector._probes["host_store"] == probes   # never probed
    assert tpool.refcounts == jpool.refcounts == {}
    assert tt.host.used_pages == jt.host.used_pages == 0


def _paged_session(tcfg, params, strat, rows=2, canvas=16):
    from repro_torch.dlm.session import DecodeSession
    pool = TPool(tcfg, n_pages=rows * canvas // PAGE + 1, page_size=PAGE,
                 strategy=strat, device="cpu")
    sess = DecodeSession(params, tcfg, strategy=strat, device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.full((rows, canvas), tcfg.mask_id, np.int64)
    tokens[:, :4] = rng.integers(0, tcfg.vocab_size - 1, (rows, 4))
    active = np.zeros((rows, canvas), bool)
    active[:, 4:] = True
    pages = [pool.alloc(canvas // PAGE) for _ in range(rows)]
    sess.attach(torch.from_numpy(tokens), active=torch.from_numpy(active),
                kv_len=torch.full((rows,), canvas, dtype=torch.int32),
                arenas=pool.arenas_for(strat),
                page_table=torch.tensor(pages, dtype=torch.int32))
    return sess, pages


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_poison_cache_pages_float_buffers_only(tiny_cfg, cache_dtype):
    """``poison_cache_pages`` writes NaN into every float buffer of the
    pages (K/V, hidden states, identifiers, int8 scales) and leaves the
    int8 codes and every other page alone; armed with
    ``poison_pages_after_refresh`` it lands inside the next step, after
    its ``refresh_interval=1`` refresh (which would otherwise wash it out),
    and that row's ``row_finite`` is False while its lane-mate's stays
    True."""
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer
    tcfg = dataclasses.replace(port_cfg(tiny_cfg), cache_dtype=cache_dtype)
    params = transformer.init_params(tcfg, seed=0, device="cpu")
    strat = SPACache(rank=16, schedule="uniform", rho_peak=0.3,
                     refresh_interval=1)
    sess, pages = _paged_session(tcfg, params, strat, canvas=32)
    arenas = sess.state.cache.arenas
    before = {k: {n: a.clone() for n, a in b.items()}
              for k, b in arenas.items()}
    sess.poison_cache_pages(pages[0])
    idx = torch.tensor(pages[0])
    rest = torch.tensor(pages[1])
    kinds = set()
    for kind, bufs in arenas.items():
        for name, a in bufs.items():
            if a.is_floating_point():
                assert torch.isnan(a[:, idx]).all(), (kind, name)
                kinds.add(name)
            else:
                assert torch.equal(a[:, idx], before[kind][name][:, idx])
            assert torch.equal(a[:, rest], before[kind][name][:, rest])
    codes = ("k", "v", "h")
    if cache_dtype == "int8":
        assert {"proxy"} | {c + "_scale" for c in codes} <= kinds
        assert not kinds & set(codes)       # the int8 codes kept
    else:
        assert {"proxy"} | set(codes) <= kinds
    # the first step runs on the attached cache (no refresh yet): the
    # poisoned row's hidden states go non-finite, its lane-mate's do not
    assert sess.step()["row_finite"].tolist() == [False, True]
    # refresh_interval=1: the second step rebuilds every page first
    assert sess.step()["row_finite"].tolist() == [True, True]
    sess.poison_pages_after_refresh(pages[1])
    assert sess.step()["row_finite"].tolist() == [True, False]
    assert sess._poison_pages is None               # one shot
    assert sess.step()["row_finite"].tolist() == [True, True]


def test_engine_accepts_fault_arguments(tiny_cfg):
    """``fault_plan=``, ``supervise=`` and ``supervisor_cfg=`` are ported:
    the injector is wired into the pool and the tier, a plan implies a
    supervisor; ``profiler=`` is ported too, so nothing waits."""
    from repro_torch.models import transformer
    from repro_torch.serving import engine as tengine
    from repro_torch.serving.supervisor import (EngineSupervisor,
                                                SupervisorConfig)
    from repro_torch.serving.profiling import StepProfiler
    assert not hasattr(tengine, "_LATER")
    tcfg = port_cfg(tiny_cfg)
    params = transformer.init_params(tcfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(
        tcfg, params, device="cpu", canvas_len=16, pool_pages=9,
        page_size=PAGE, prefix_cache=True, host_pages=4,
        fault_plan=tfaults.FaultPlan(seed=1))
    assert isinstance(eng.supervisor, EngineSupervisor)
    assert eng.pool.fault_hook is eng.faults is eng.tier.injector
    eng = tengine.ServingEngine(tcfg, params, device="cpu",
                                supervisor_cfg=SupervisorConfig())
    assert eng.supervisor is not None and eng.faults is None
    assert tengine.ServingEngine(tcfg, params, device="cpu").supervisor \
        is None
    prof = StepProfiler()
    assert tengine.ServingEngine(tcfg, params, device="cpu",
                                 fault_plan=tfaults.FaultPlan(seed=1),
                                 profiler=prof).profiler is prof


# ---------------------------------------------------------------------------
# serve --supervise --chaos-seed
# ---------------------------------------------------------------------------

def test_serve_cli_supervise_and_chaos(capsys):
    """``--supervise --chaos-seed 7`` (every site at ``--chaos-rate``) runs
    offline on the CPU: the chaos line, the served count, the fault
    counters in the registry dump, and ``<faulted>`` for an aborted
    request's output; with ``--profile`` the step decomposition too."""
    argv = ["--device", "cpu", "--arch", "internlm2-1.8b", "--requests",
            "6", "--gen-len", "6", "--canvas", "24", "--max-batch", "2",
            "--pool-pages", "16", "--page-size", "4", "--host-pages", "8",
            "--supervise", "--chaos-seed", "7", "--chaos-rate", "0.2"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "chaos: seed=7 rate=0.2 on all sites" in out
    assert "spa_fault_injected_total" in out
    assert "spa_fault_invariant_checks_total" in out
    assert "served " in out
    assert tserve.main(argv + ["--profile"]) == 0
    out = capsys.readouterr().out
    assert "step-time decomposition (host-loop, fenced)" in out
    assert "chaos: seed=7 rate=0.2 on all sites" in out
