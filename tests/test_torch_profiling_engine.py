"""PyTorch port vs the JAX package: profiling and runtime accounting
through the ServingEngine (the engine scenarios of the JAX
``tests/test_profiling.py``).

* a profiled engine serves what the JAX engine serves, and what the port
  serves unprofiled, and every lane step is observed;
* trace accounting: over the same traffic (cold, partial and full prefix
  hits, a preemption) the port's trace counts equal the JAX tracker's,
  function for function and lane for lane;
* off means off: no ``spa_profile_*`` series without a profiler;
* the ``spa_runtime_*`` and pool series land in a valid Prometheus render;
* ``pool_debug_state`` (``/debug/pool``) stays valid JSON at every step of
  a preempting, demoting run, with ``live_executables``, and the live
  endpoint serves it mid-stream.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

from repro.core import runtime as jruntime
from repro.core.strategy import SPACache as JSPACache
from repro.serving.profiling import StepProfiler as JStepProfiler
from repro.serving.telemetry import Telemetry as JTelemetry

from _torch_parity import assert_engines_match, engine_pair, port_cfg
from test_telemetry import _assert_prometheus_text
from repro_torch.core import runtime
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.profiling import StepProfiler
from repro_torch.serving.telemetry import Telemetry

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
SPA = dict(rank=16, schedule="uniform", rho_peak=0.3)


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size - 1, 8).astype(np.int32)
            for _ in range(n)]


def _churn(eng, cfg):
    """Cold, full-hit, partial-hit and preempting traffic: a prompt served
    alone (it publishes), then its repeat, two prompts sharing its first
    page, and a priority-5 repeat arriving at the second step."""
    base = _prompts(cfg, 1)[0]
    other = _prompts(cfg, 2, seed=1)
    shared = [np.concatenate([base[:4], o[:4]]) for o in other]
    eng.submit(base, gen_len=8)
    eng.run()
    for p in [base] + shared:
        eng.submit(p, gen_len=8)
    s0 = eng.stats.steps

    def on_step(e):
        if e.stats.steps == s0 + 2:
            e.submit(base, gen_len=8, priority=5)

    eng.run(on_step=on_step)
    return eng


def test_profiled_engine_traces_equal_jax(tiny_cfg, tiny_params):
    jtr, ttr = jruntime.compile_tracker(), runtime.compile_tracker()
    jtr.reset()
    ttr.reset()
    jprof = JStepProfiler(JTelemetry.enabled(dynamics_every=0))
    tprof = StepProfiler(Telemetry.enabled(dynamics_every=0))
    kw = dict(max_batch=2, canvas_len=CANVAS, pool_pages=13,
              page_size=PAGE, prefix_cache=True)
    jeng, teng = engine_pair(tiny_cfg, tiny_params,
                             (JSPACache(**SPA), TSPACache(**SPA)),
                             jextra=dict(profiler=jprof),
                             textra=dict(profiler=tprof), **kw)
    _churn(jeng, tiny_cfg)
    _churn(teng, tiny_cfg)
    outs = assert_engines_match(jeng, teng)
    assert teng.stats.preemptions > 0
    assert teng.stats.prefix_full_hits > 0
    assert teng.stats.prefix_hits > teng.stats.prefix_full_hits  # partial
    # every lane step fenced, on both sides
    assert tprof.steps_observed == jprof.steps_observed == teng.stats.steps
    # traces: the same functions, the same counts per lane
    assert ttr.traces == jtr.traces
    assert ttr.traces["prefill_partial"] > 0
    assert sorted(ttr.lane_traces.values()) == \
        sorted(jtr.lane_traces.values())
    assert [lane.replace("/cuda/", "/xla/") for lane in ttr.lane_traces] \
        == list(jtr.lane_traces)
    # profiled equals unprofiled
    plain = TEngine(teng.cfg, teng.params, strategy=teng.strategy,
                    device="cpu", **kw)
    plain._proxies = teng._proxies
    _churn(plain, tiny_cfg)
    for r in plain.done:
        np.testing.assert_array_equal(r.output, outs[r.uid])
    assert plain.stats.steps == teng.stats.steps


def test_disabled_profiling_adds_no_registry_entries(tiny_cfg, tiny_params):
    from repro_torch.models import transformer
    tcfg = port_cfg(tiny_cfg)
    tel = Telemetry.enabled(dynamics_every=1)
    eng = TEngine(tcfg, transformer.init_params(tcfg, seed=0, device="cpu"),
                  max_batch=2, canvas_len=CANVAS, strategy=TSPACache(**SPA),
                  pool_pages=9, page_size=PAGE, telemetry=tel, device="cpu")
    eng.submit(_prompts(tiny_cfg, 1)[0], gen_len=8)
    eng.run()
    snap = tel.registry.snapshot()
    assert not any(k.startswith("spa_profile_") for k in snap)
    assert 'spa_runtime_trace_total{fn="serve_step"}' in snap


def test_metrics_render_includes_runtime_and_pool_series(tiny_cfg):
    from repro_torch.models import transformer
    tcfg = port_cfg(tiny_cfg)
    tel = Telemetry.enabled(dynamics_every=0)
    eng = TEngine(tcfg, transformer.init_params(tcfg, seed=0, device="cpu"),
                  max_batch=2, canvas_len=CANVAS, strategy=TSPACache(**SPA),
                  pool_pages=9, page_size=PAGE, telemetry=tel,
                  profiler=StepProfiler(tel), device="cpu")
    eng.submit(_prompts(tiny_cfg, 1, seed=1)[0], gen_len=8)
    eng.run()
    text = eng.render_metrics()
    _assert_prometheus_text(text)
    for series in ("spa_runtime_trace_total",
                   "spa_runtime_live_executables",
                   "spa_pool_peak_pages_used",
                   "spa_pool_max_contiguous_free_run",
                   "spa_pool_arena_bytes_total",
                   "spa_profile_step_seconds"):
        assert series in text, f"missing {series} in /metrics render"
    # on the CPU nothing is loaded: no live executable
    assert "spa_runtime_live_executables 0" in text


def test_debug_pool_json_mid_churn(tiny_cfg, tiny_params):
    """``pool_debug_state()`` stays JSON-serializable at every step of a
    preempting and demoting run, and the live ``/debug/pool`` endpoint
    serves it mid-stream (the JAX scenario)."""
    from repro_torch.models import transformer
    from repro_torch.serving.frontend import (AsyncFrontend,
                                              fetch_debug_pool,
                                              stream_request)
    tcfg = port_cfg(tiny_cfg)
    eng = TEngine(tcfg, transformer.init_params(tcfg, seed=0, device="cpu"),
                  max_batch=2, canvas_len=CANVAS,
                  strategy=TSPACache(**SPA, refresh_interval=1),
                  pool_pages=9, page_size=PAGE, prefix_cache=True,
                  host_pages=16, host_dtype="f32",
                  telemetry=Telemetry.enabled(dynamics_every=0),
                  device="cpu")
    prompts = _prompts(tiny_cfg, 4)
    eng.submit(prompts[0], gen_len=8)
    eng.run()
    for p in prompts[1:3]:
        eng.submit(p, gen_len=8)
    s0 = eng.stats.steps
    states = []

    def on_step(e):
        if e.stats.steps == s0 + 2:
            e.submit(prompts[3], gen_len=8, priority=5)
        states.append(json.loads(json.dumps(e.pool_debug_state())))

    eng.run(on_step=on_step)
    assert eng.stats.preemptions > 0, "churn never preempted"
    assert states
    for st in states:
        assert st["paged"] is True
        assert st["pool"]["used"] <= st["pool"]["capacity"]
        frag = st["pool"]["fragmentation"]
        assert frag["max_contiguous_run"] <= frag["free_pages"]
        assert st["live_executables"] == runtime.live_executable_count() == 0
    assert any(st["tier"]["demoted_pages"] > 0 for st in states), \
        "churn never demoted"

    async def main():
        front = AsyncFrontend(eng, max_steps=2048)
        await front.start(serve_http=True)
        try:
            mid = None
            async for ev in stream_request(front.host, front.port,
                                           prompts[0], 6):
                if ev["kind"] == "token" and mid is None:
                    mid = await fetch_debug_pool(front.host, front.port)
        finally:
            await front.stop()
        return mid

    mid = asyncio.run(main())
    assert mid is not None and mid["paged"] is True
    assert set(mid["pool"]) >= {"capacity", "used", "fragmentation",
                                "arena_bytes"}
    assert mid["host_pool"]["unit_budget"] > 0
    assert mid["live_executables"] == 0


@pytest.mark.parametrize("sample_every", [1, 3])
def test_engine_profiler_samples_lane_steps(tiny_cfg, sample_every):
    """The engine hands its profiler to every lane session: a lane's
    fenced steps follow ``sample_every`` over the session's own step
    count."""
    from repro_torch.models import transformer
    tcfg = port_cfg(tiny_cfg)
    prof = StepProfiler(sample_every=sample_every)
    eng = TEngine(tcfg, transformer.init_params(tcfg, seed=0, device="cpu"),
                  max_batch=2, canvas_len=CANVAS, strategy=TSPACache(**SPA),
                  device="cpu", profiler=prof)
    eng.submit(_prompts(tiny_cfg, 1)[0], gen_len=8)
    eng.run()
    (sess,) = eng._sessions.values()
    assert sess.profiler is prof and sess.label.endswith("#0")
    assert prof.steps_observed == len(range(0, sess.steps_taken,
                                            sample_every))
