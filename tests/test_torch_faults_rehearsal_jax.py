"""Phase 16(b)'s rehearsal through the JAX engine.

``chip_smoke.FAULT_PLAN`` fires every site once by step 6 of 16(b)'s chaos
pass and ``FAULT_SUPERVISOR`` brings the ladder back to L0 by step 26, so
the pass's first 30 steps settle every constant the card asserts
(``FAULT_EXPECT``): after them the plan has nothing left to fire, and with
no fault the ladder, the aborted and the canceled uids cannot move.  The
JAX engine and the port (2 reduced LLaDA layers, the same weights and
proxies) run those 30 steps of the pass (the JAX engine takes about a
second a step at canvas 256 on the CPU, so the whole 198-step pass is
left to the port, ``test_torch_faults_rehearsal.py``) and agree on the
injector log, the outcomes and outputs so far, the fault counters and the
trace's fault and ladder instants; both give ``FAULT_EXPECT``.
"""
import dataclasses
import pathlib
import sys

import jax
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import strategy_from_spec as jspec
from repro.models import transformer
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.supervisor import SupervisorConfig as JSupervisorConfig
from repro.serving.telemetry import Telemetry as JTelemetry
from repro.serving.telemetry import Tracer as JTracer

from _torch_parity import (FAULT_STATS, fault_instants, fault_outcomes,
                           port_cfg, port_params, port_proxies)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
STEPS = 30


class _Stop(Exception):
    pass


def _stop_at(engine):
    if engine.stats.steps >= STEPS:
        raise _Stop


def test_phase16b_first_steps_match_jax():
    from repro_torch.core.strategy import strategy_from_spec as tspec
    from repro_torch.serving.telemetry import Telemetry, Tracer
    cfg = reduced(get_arch("llada-8b"), n_layers=2)
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    c = cs.FAULT_FULL
    jstrat = dataclasses.replace(jspec(cfg.spa), refresh_interval=1)
    jeng = JEngine(cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
                   strategy=jstrat, pool_pages=c["pool"], page_size=c["page"],
                   prefix_cache=True, host_pages=c["host"], host_dtype="f32",
                   fault_plan=JFaultPlan(**cs.FAULT_PLAN), supervise=True,
                   supervisor_cfg=JSupervisorConfig(**cs.FAULT_SUPERVISOR),
                   telemetry=JTelemetry(tracer=JTracer(enabled=True)))
    tcfg = port_cfg(cfg)
    tstrat = dataclasses.replace(tspec(tcfg.spa), refresh_interval=1)
    teng = cs.fault_engine(
        tcfg, port_params(params, tcfg), tstrat,
        port_proxies(jeng._proxies_for(jeng.strategy), tcfg), c,
        plan=cs.FAULT_PLAN, sup=cs.FAULT_SUPERVISOR,
        telemetry=Telemetry(tracer=Tracer(enabled=True)), device="cpu")
    for eng in (jeng, teng):
        for i, (prompt, gen, prio) in enumerate(cs.fault_traffic(c)):
            on = i in c["stream"]
            eng.submit(prompt, gen, priority=prio, stream=on,
                       sink=(lambda ev: None) if on else None)
        try:
            eng.run(on_step=_stop_at)
        except _Stop:
            pass
        assert eng.stats.steps == STEPS
        assert cs.fault_outcome(eng) == cs.FAULT_EXPECT
        plan = cs.FAULT_PLAN["at"]
        assert eng.faults.fired == {s: len(plan.get(s, ())) for s in plan} \
            | {s: 0 for s in eng.faults.fired if s not in plan}
        assert eng.supervisor.level == 0 and not eng.supervisor._events
    assert teng.faults.log == jeng.faults.log
    assert fault_outcomes(teng) == fault_outcomes(jeng)
    for name in FAULT_STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.tier_store_faults == jeng.tier.store_faults == 1
    assert teng.stats.host_corrupt_pages == jeng.tier.checksum_failures
    assert fault_instants(teng) == fault_instants(jeng)
    assert teng.pool.refcounts == jeng.pool.refcounts
    assert sorted(teng._running) == sorted(jeng._running)
