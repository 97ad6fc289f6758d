"""PyTorch port vs the JAX package: stuck lanes, disconnects and the
degradation ladder.

The JAX ``tests/test_faults.py`` scenarios through both engines: the
watchdog force-preempting a stalled lane within its step-clock budget
(outputs equal a fault-free run's), a disconnect burst canceling the
streaming request only, the ladder climbing L0 -> L3 under pressure and
walking back one rung a quiet cooldown (with its flags on the engine and
the index), and L3 shedding low-priority queued work.  Each compares the
injector log, the outcomes, the fault counters, ``degradation_events`` and
the trace's ``fault:*`` and ``ladder`` instants.
"""
import numpy as np
import torch

from _torch_parity import (assert_fault_runs_match, fault_engines,
                           fault_instants, fault_outcomes)

torch.set_num_threads(1)


def _prompts(cfg, n, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size - 1, 8).astype(np.int32)
            for _ in range(n)]


def test_watchdog_recovers_stuck_lane(tiny_cfg, tiny_params):
    prompts = _prompts(tiny_cfg, 2)
    _, base = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                            prefix_cache=False, supervise=True)
    budget = 4
    jeng, teng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                               prefix_cache=False,
                               plan=dict(at={"lane_stall": (0,)}),
                               sup=dict(watchdog_budget=budget))
    for eng in (base, jeng, teng):
        for p in prompts:
            eng.submit(p, gen_len=8)
        eng.run()
    got = assert_fault_runs_match(jeng, teng)
    assert teng.stats.watchdog_fires == 1
    assert teng.stats.preemptions >= 2       # the whole lane preempted
    assert teng.stats.requests_done == 2
    want = fault_outcomes(base)
    assert {u: o[3] for u, o in got.items()} == \
        {u: o[3] for u, o in want.items()}       # resume: bit-equal
    assert teng.stats.steps <= 2 * base.stats.steps + budget + 2
    assert teng.pool.used == 0


def test_disconnect_burst_cancels_streaming_only(tiny_cfg, tiny_params):
    prompts = _prompts(tiny_cfg, 2)
    jeng, teng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                               prefix_cache=False,
                               plan=dict(at={"disconnect": (1,)}))
    events = {}
    for eng in (jeng, teng):
        got = events[eng] = []
        eng.submit(prompts[0], gen_len=8, stream=True, sink=got.append)
        eng.submit(prompts[1], gen_len=8)
        eng.run()
    assert_fault_runs_match(jeng, teng)
    assert teng.stats.disconnect_bursts == 1
    assert teng.stats.requests_canceled == 1
    assert teng.stats.requests_done == 1
    by_uid = {r.uid: r for r in teng.done}
    assert by_uid[0].canceled and by_uid[0].output is None
    assert [(e.kind, e.step, e.positions, e.tokens) for e in events[teng]] \
        == [(e.kind, e.step, e.positions, e.tokens) for e in events[jeng]]
    assert events[teng][-1].kind == "canceled"
    assert teng.pool.used == 0


def test_degradation_ladder_up_and_down(tiny_cfg, tiny_params):
    """Pressure ticks drive both supervisors alike: L1 pauses publication,
    L2 the host tier (the index stops demoting), L3 sheds; 40 quiet steps
    walk back to L0 one rung a cooldown."""
    jeng, teng = fault_engines(
        tiny_cfg, tiny_params, pool_pages=13, prefix_cache=True,
        host_pages=16, sup=dict(pressure_window=4, escalate_at=2,
                                cooldown=2, shed_below=1,
                                hopeless_margin=0.5))
    levels = {}
    for eng in (jeng, teng):
        sup = eng.supervisor

        def tick(n=1, pressure=0, eng=eng, sup=sup):
            for _ in range(n):
                eng.stats.steps += 1
                for _ in range(pressure):
                    sup.note_pressure("test")
                sup.on_iteration()

        tick(3, pressure=1)
        assert sup.level >= 1 and eng._publish_paused
        tick(6, pressure=1)
        assert sup.level == 3
        assert eng._host_tier_paused and eng.prefix.demote_paused
        assert eng._shed_low_priority and eng._shed_below == 1
        assert eng._hopeless_margin == 0.5
        tick(40)
        assert sup.level == 0 and eng.stats.degrade_level == 0
        assert not eng._publish_paused and not eng._host_tier_paused
        assert not eng.prefix.demote_paused
        assert not eng._shed_low_priority and eng._hopeless_margin == 0.0
        levels[eng] = [lvl for _, lvl in eng.stats.degradation_events]
    assert levels[teng] == levels[jeng] == [1, 2, 3, 2, 1, 0]
    assert teng.stats.degradation_events == jeng.stats.degradation_events
    assert fault_instants(teng) == fault_instants(jeng)
    assert [a["to"] for _, a in fault_instants(teng)] == [1, 2, 3, 2, 1, 0]
    assert (teng.stats.degradations, teng.stats.restorations) == (3, 3)
    assert teng.stats.invariant_checks == jeng.stats.invariant_checks == 49


def test_ladder_l3_sheds_low_priority_queued(tiny_cfg, tiny_params):
    jeng, teng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                               prefix_cache=True, sup=dict(shed_below=1))
    lo_p = _prompts(tiny_cfg, 1)[0]
    hi_p = _prompts(tiny_cfg, 1, seed=5)[0]
    for eng in (jeng, teng):
        eng.supervisor._set_level(3, step=0)
        eng.submit(lo_p, gen_len=8, priority=0)
        eng.submit(hi_p, gen_len=8, priority=2)
        eng.run()
    assert_fault_runs_match(jeng, teng)
    by_uid = {r.uid: r for r in teng.done}
    assert by_uid[0].shed and by_uid[0].output is None
    assert by_uid[1].output is not None
    assert teng.stats.requests_shed == 1 and teng.stats.requests_done == 1
    assert teng.stats.publish_paused_skips == jeng.stats.publish_paused_skips
