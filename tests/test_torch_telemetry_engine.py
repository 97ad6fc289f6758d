"""PyTorch port vs the JAX package: telemetry through the serving engine.

The churn run of the JAX ``tests/test_telemetry.py`` (a cold request
published, two more evicting and demoting it, a priority-5 arrival that
preempts, then the first prompt again, promoted from the host tier) through
the port's engine with ``Telemetry.enabled(dynamics_every=1)`` and with
telemetry off: the same outputs, one closed span tree per request across
preemption, the engine-phase spans and counters of every step, the demote
and promote instants, and a Chrome trace that loads.  The same churn through
the JAX engine gives the same metric names from ``render_metrics`` (but the
``spa_runtime_*`` series of the JAX compile tracker, which come with the
profiling slice) and the same counter values.  ``cache_dynamics`` equals
the JAX session's on the same decode: changed-row counts exact, drift
within 1e-6, the same overlaps.
"""
import json
import re

import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache
from repro.serving.telemetry import Telemetry as JTelemetry

from _torch_parity import engine_pair, port_params, port_proxies, port_cfg
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.serving.telemetry import (PID_ENGINE, PID_EVENTS,
                                           PID_REQUESTS, Histogram,
                                           Telemetry)

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
# the strategy's own refresh schedule, so that the dynamics probe sees
# incremental steps (budget utilization, drift, overlap) and the JAX engine
# runs no eager refresh a step
SPEC = dict(rank=16, schedule="uniform", rho_peak=0.3)


def _churn(eng):
    """The JAX test's churn workload on ``eng`` (pool 9 pages of 4, 2
    slots, host tier of 16 f32 pages)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab_size - 1, 8).astype(np.int32)
               for _ in range(4)]
    eng.submit(prompts[0], gen_len=8)
    eng.run()                           # cold p0: prefill + publish
    for p in prompts[1:3]:
        eng.submit(p, gen_len=8)        # the full pool demotes p0
    s0 = eng.stats.steps

    def on_step(e):
        if e.stats.steps == s0 + 2:     # priority arrival on a full pool
            e.submit(prompts[3], gen_len=8, priority=5)

    eng.run(on_step=on_step)
    eng.submit(prompts[0], gen_len=8)   # warm p0: promoted
    eng.run()
    return eng


def _engines(cfg, params, jtel, ttel):
    return engine_pair(cfg, params, (JSPACache(**SPEC), TSPACache(**SPEC)),
                       jextra=dict(telemetry=jtel),
                       textra=dict(telemetry=ttel), max_batch=2,
                       canvas_len=CANVAS, pool_pages=9, page_size=PAGE,
                       prefix_cache=True, host_pages=16, host_dtype="f32")


@pytest.fixture(scope="module")
def churn(tiny_cfg, tiny_params):
    """(JAX engine traced, port engine traced, port engine untraced)."""
    jeng, teng = _engines(tiny_cfg, tiny_params,
                          JTelemetry.enabled(dynamics_every=1),
                          Telemetry.enabled(dynamics_every=1))
    _, off = _engines(tiny_cfg, tiny_params, None, None)
    _churn(teng)
    _churn(off)
    _churn(jeng)
    assert teng.stats.preemptions > 0, "churn never preempted"
    assert teng.stats.prefix_demoted_pages > 0, "churn never demoted"
    assert teng.stats.prefix_promotions > 0, "churn never promoted"
    return jeng, teng, off


def test_telemetry_on_is_byte_identical(churn):
    _, on, off = churn
    outs_on = {r.uid: np.asarray(r.output).tobytes() for r in on.done}
    outs_off = {r.uid: np.asarray(r.output).tobytes() for r in off.done}
    assert outs_on == outs_off and len(outs_on) == 5
    assert on.stats.steps == off.stats.steps
    assert on.stats.preemptions == off.stats.preemptions
    assert not off.telemetry.tracing and off.telemetry.tracer.events == []


def test_request_span_trees(churn):
    """One span tree per uid: one closed ``request`` root, ``queued`` and
    ``running`` alternating through preempt / resume, children inside the
    root, and no span left open."""
    _, on, _ = churn
    tr = on.telemetry.tracer
    assert tr.open_spans() == []
    for r in on.done:
        evs = tr.span_events(PID_REQUESTS, r.uid)
        names = [e.name for e in evs]
        assert names.count("request") == 1
        assert names.count("queued") == 1 + r.preemptions
        assert names.count("running") == 1 + r.preemptions
        root = next(e for e in evs if e.name == "request")
        assert root.args["outcome"] == "done"
        for e in evs:
            assert e.ts >= root.ts - 1e-9
            assert e.ts + e.dur <= root.ts + root.dur + 1e-9
        preempts = [e for e in tr.events if e.ph == "i"
                    and e.pid == PID_REQUESTS and e.tid == r.uid
                    and e.name == "preempt"]
        assert len(preempts) == r.preemptions


def test_step_spans_and_counters(churn):
    """Every engine step has one ``dispatch``, ``host_overlap`` and
    ``host_sync`` span, in that order on its lane's track, each folded into
    ``spa_engine_phase_seconds``; the pool, host-tier and queue counters
    are sampled every step."""
    _, on, _ = churn
    tr = on.telemetry.tracer
    phases = [e.name for e in tr.span_events(PID_ENGINE)]
    steps = on.stats.steps
    assert phases == ["dispatch", "host_overlap", "host_sync"] * steps
    for lane in {e.tid for e in tr.span_events(PID_ENGINE)}:
        seq = tr.span_events(PID_ENGINE, lane)
        for a, b in zip(seq, seq[1:]):
            assert a.ts + a.dur <= b.ts + 1e-9      # never overlapping
    snap = on.telemetry.registry.snapshot()
    for phase in ("dispatch", "host_overlap", "host_sync"):
        assert snap[f'spa_engine_phase_seconds{{phase="{phase}"}}'][
            "count"] == steps
    for name, keys in (("pool_pages", {"used", "free"}),
                       ("host_tier_units", {"used"}),
                       ("queue_depth", {"queued", "running"})):
        samples = [e for e in tr.events if e.ph == "C" and e.name == name]
        assert len(samples) == steps and all(
            set(e.args) == keys for e in samples), name


def test_demote_promote_instants(churn):
    _, on, _ = churn
    tr = on.telemetry.tracer
    demotes = [e for e in tr.events if e.ph == "i" and e.name == "demote"]
    assert demotes and all(e.pid == PID_EVENTS for e in demotes)
    assert sum(e.args["demoted"] for e in demotes) \
        == on.stats.prefix_demoted_pages
    assert sum(e.args["freed"] for e in demotes) \
        == on.stats.prefix_evicted_pages
    promotes = [e for e in tr.events if e.ph == "i" and e.name == "promote"]
    assert len(promotes) == on.stats.prefix_promotions
    assert sum(e.args["pages"] for e in promotes) \
        == on.stats.prefix_promoted_pages
    for e in promotes:
        assert e.pid == PID_REQUESTS
        names = [x.name for x in tr.span_events(PID_REQUESTS, e.tid)]
        assert names.count("request") == 1


def test_stats_histograms_single_source(churn):
    """EngineStats' latency lists are registry histograms whose
    percentiles are numpy's on the retained samples."""
    _, on, _ = churn
    s = on.stats
    for h in (s.e2e_latencies, s.queue_waits, s.ttft_latencies,
              s.tpot_latencies):
        assert isinstance(h, Histogram) and len(h) == len(list(h)) > 0
    pct = s.percentiles()
    for name, h in (("e2e", s.e2e_latencies), ("wait", s.queue_waits),
                    ("ttft", s.ttft_latencies), ("tpot", s.tpot_latencies)):
        for q in (50, 95):
            assert pct[f"{name}_p{q}"] == pytest.approx(
                float(np.percentile(list(h), q)), rel=1e-12)


def test_chrome_trace_export(churn, tmp_path):
    _, on, _ = churn
    path = tmp_path / "trace.json"
    on.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} <= {"X", "i", "C", "M"}
    tracks = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "lane0" in tracks and "req 0" in tracks
    for e in evs:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
    assert any(e["ph"] == "i" and e["name"] == "preempt" for e in evs)
    assert any(e["ph"] == "i" and e["name"] == "promote" for e in evs)


def _series(text):
    """{metric name: kind} from ``# TYPE`` lines and {sample: value} of the
    counters, without the JAX compile tracker's ``spa_runtime_*``."""
    kinds = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    kinds = {k: v for k, v in kinds.items()
             if not k.startswith("spa_runtime_")}
    counters = {}
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if not line.startswith("#") and kinds.get(name) == "counter":
            sample, value = line.rsplit(" ", 1)
            counters[sample] = float(value)
    return kinds, counters


def test_metric_names_and_counters_match_jax(churn):
    jeng, teng, _ = churn
    np.testing.assert_array_equal(
        np.stack([r.output for r in teng.done]),
        np.stack([np.asarray(r.output) for r in jeng.done]))
    tkinds, tcount = _series(teng.render_metrics())
    jkinds, jcount = _series(jeng.render_metrics())
    assert tkinds == jkinds
    assert tcount == jcount
    assert tcount["spa_engine_steps_total"] == teng.stats.steps
    assert tcount["spa_fault_requests_faulted_total"] == 0
    for name in ("spa_cache_budget_utilization_ratio",
                 "spa_cache_proxy_drift", "spa_cache_selection_overlap_ratio",
                 "spa_prefix_hit_depth_pages", "spa_pool_pages_used",
                 "spa_tier_units_used", "spa_prefix_held_pages"):
        assert name in tkinds, name


def test_cache_dynamics_match_jax(tiny_cfg, tiny_params):
    """``cache_dynamics`` after every step of the same dense decode: None
    right after prefill in both, then the same refreshed flag, changed-row
    counts and overlaps, and drifts within 1e-6."""
    import jax.numpy as jnp
    from repro.dlm.session import DecodeSession as JSession
    from repro_torch.dlm.session import DecodeSession as TSession
    prompt = np.random.default_rng(5).integers(
        0, tiny_cfg.vocab_size - 1, (2, 8))
    js = JSession(tiny_params, tiny_cfg, strategy=JSPACache(**SPEC))
    js.prefill(jnp.asarray(prompt), 8)
    tcfg = port_cfg(tiny_cfg)
    ts = TSession(port_params(tiny_params, tcfg), tcfg,
                  strategy=TSPACache(**SPEC),
                  spa_proxies=port_proxies(js.spa_proxies, tcfg),
                  device="cpu")
    ts.prefill(torch.from_numpy(prompt), 8)
    assert js.cache_dynamics() is None and ts.cache_dynamics() is None
    seen = 0
    for _ in range(6):
        js.step()
        ts.step()
        jd, td = js.cache_dynamics(), ts.cache_dynamics()
        assert td["refreshed"] == jd["refreshed"]
        assert sorted(td["kinds"]) == sorted(jd["kinds"])
        for kind, jl in jd["kinds"].items():
            for j, t in zip(jl, td["kinds"][kind], strict=True):
                assert (t["changed"], t["rows"], t["overlap"]) == (
                    j["changed"], j["rows"], j["overlap"])
                np.testing.assert_allclose(t["drift"], j["drift"],
                                           rtol=0, atol=1e-6)
                seen += t["changed"]
    assert seen > 0, "no row changed"
