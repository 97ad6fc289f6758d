"""PyTorch port vs the JAX package: the metrics registry and span tracer
(``serving/telemetry.py``), without an engine.

The port keeps its own copy of the module; the bar is that it renders and
computes exactly what the JAX module does: ``percentile`` and ``Histogram``
percentiles equal numpy's and JAX's on the same samples, the Prometheus
text of the same sequence of registry operations is the same string, the
tracer refuses the same misuse, and the Chrome trace of the same spans,
instants and counters is the same document.
"""
import itertools
import json
import re

import numpy as np
import pytest

from repro.serving import telemetry as jtel
from repro_torch.serving import telemetry as ttel


def _counter_clock():
    c = itertools.count()
    return lambda: next(c) * 1e-3


@pytest.mark.parametrize("n", [1, 2, 5, 17, 100, 1000])
def test_percentile_matches_numpy_and_jax(n):
    xs = np.random.default_rng(n).exponential(1.0, n).tolist()
    th, jh = ttel.Histogram("t_seconds"), jtel.Histogram("t_seconds")
    th.extend(xs)
    jh.extend(xs)
    for q in (0, 10, 25, 50, 90, 95, 99, 100):
        want = float(np.percentile(xs, q))
        assert ttel.percentile(xs, q) == pytest.approx(want, rel=1e-12)
        assert th.percentile(q) == jh.percentile(q)
        assert th.percentile(q) == pytest.approx(want, rel=1e-12)
    assert th.mean == jh.mean and th.sum == jh.sum
    assert th.bucket_counts == jh.bucket_counts
    assert ttel.percentile([], 50) == 0.0


def test_histogram_list_compat_and_capped_estimate():
    """List-compatible as EngineStats needs, and past ``max_samples`` the
    bucket estimate equals JAX's."""
    h = ttel.Histogram("t_seconds")
    assert not h and len(h) == 0
    h.append(2.0)
    h.observe(4.0)
    assert h and len(h) == 2 and sorted(h) == [2.0, 4.0]
    assert h.mean == pytest.approx(3.0)
    xs = np.random.default_rng(7).lognormal(0.0, 2.0, 300).tolist()
    th = ttel.Histogram("t", max_samples=50)
    jh = jtel.Histogram("t", max_samples=50)
    th.extend(xs)
    jh.extend(xs)
    assert len(th.samples) == 50 and len(th) == 300
    for q in (5, 50, 95, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert ttel.DEFAULT_LATENCY_BUCKETS == jtel.DEFAULT_LATENCY_BUCKETS


def _registry_ops(mod):
    """One sequence of registry operations, with the module's classes."""
    reg = mod.MetricsRegistry()
    reg.counter("spa_engine_steps_total", "iterations").inc(3)
    reg.counter("spa_engine_steps_total").inc(2.5)
    reg.gauge("spa_pool_pages_used", "pages", labels={"tier": "hbm"}).set(7)
    reg.gauge("spa_pool_pages_used", labels={"tier": "host"}).inc(1.25)
    h = reg.histogram("spa_engine_ttft_seconds", "ttft",
                      buckets=(0.1, 1.0, 10.0))
    for x in (0.05, 0.5, 5.0, 50.0):
        h.observe(x)
    lab = reg.histogram("spa_cache_proxy_drift", "drift",
                        labels={"kind": "attn", "layer": "1"},
                        buckets=(1e-6, 1e-3, 1.0))
    lab.extend([1e-7, 2e-4, 0.3])
    own = mod.Histogram("x", "own help")
    own.extend([0.2, 0.4])
    reg.adopt(own, "spa_engine_e2e_latency_seconds", "e2e latency")
    reg.counter("spa_fault_injected_total", "fires")     # stays zero
    seen = []
    reg.add_collector(lambda: seen.append(1))
    reg.add_collector(
        lambda: reg.gauge("spa_engine_queue_depth", "queued").set(len(seen)))
    return reg


def test_registry_render_snapshot_summary_equal_jax():
    treg, jreg = _registry_ops(ttel), _registry_ops(jtel)
    text = treg.render()
    assert text == jreg.render()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.format_summary() == jreg.format_summary()
    assert (treg.format_summary(skip_zero=True)
            == jreg.format_summary(skip_zero=True))
    # Prometheus text format 0.0.4, cumulative buckets closed by +Inf
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$")
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        if not line.startswith("# "):
            assert sample.match(line), line
            float(line.rsplit(" ", 1)[1])
    counts = [int(m.group(1)) for m in re.finditer(
        r'spa_engine_ttft_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert counts == sorted(counts) and counts[-1] == 4
    assert "no metrics recorded" in ttel.MetricsRegistry().format_summary()
    with pytest.raises(AssertionError, match="re-registered"):
        treg.gauge("spa_engine_steps_total")


def test_tracer_span_integrity_errors():
    for mod in (ttel, jtel):
        tr = mod.Tracer(clock=_counter_clock())
        with pytest.raises(RuntimeError, match="no open span"):
            tr.end(1, 1, "request")
        tr.begin(1, 1, "request")
        tr.begin(1, 1, "queued")
        with pytest.raises(RuntimeError, match="innermost"):
            tr.end(1, 1, "request")         # out-of-order close
        assert tr.close_track(1, 1) == 2    # innermost first
        assert tr.open_spans() == []
        assert [e.name for e in tr.span_events(1, 1)] == ["queued",
                                                          "request"]
        off = mod.Tracer(enabled=False)
        assert off.begin(1, 1, "x") is None and off.end(1, 1) is None
        assert off.close_track(1, 1) == 0 and off.events == []


def _trace_ops(mod):
    tr = mod.Tracer(clock=_counter_clock())
    tr.name_track(mod.PID_ENGINE, 0, "lane0")
    tr.name_track(mod.PID_REQUESTS, 3, "req 3")
    tr.begin(mod.PID_REQUESTS, 3, "request", cat="lifecycle",
             args={"gen_len": 6})
    tr.begin(mod.PID_REQUESTS, 3, "queued", cat="lifecycle")
    tr.end(mod.PID_REQUESTS, 3, "queued")
    tr.begin(mod.PID_ENGINE, 0, "dispatch", cat="phase")
    tr.end(mod.PID_ENGINE, 0, "dispatch")
    tr.instant(mod.PID_EVENTS, 2, "demote", cat="tier",
               args={"freed": 2, "step": 4})
    tr.counter(mod.PID_ENGINE, "pool_pages", {"used": 3, "free": 5})
    tr.close_track(mod.PID_REQUESTS, 3, args={"outcome": "shed"})
    return tr


def test_chrome_trace_schema_equal_jax(tmp_path):
    t, j = _trace_ops(ttel), _trace_ops(jtel)
    assert t.event_stream() == j.event_stream()
    assert t.to_chrome_trace() == j.to_chrome_trace()
    path = tmp_path / "trace.json"
    t.export(str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i", "C", "M"}
    meta = {e["args"]["name"] for e in evs
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert meta == {"engine", "requests", "events", "device"}
    for e in evs:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0
        if e["ph"] == "i":
            assert e["s"] == "t"
    assert (ttel.PID_ENGINE, ttel.PID_REQUESTS, ttel.PID_EVENTS,
            ttel.PID_DEVICE) == (jtel.PID_ENGINE, jtel.PID_REQUESTS,
                                 jtel.PID_EVENTS, jtel.PID_DEVICE)


def test_telemetry_facade():
    off = ttel.Telemetry.disabled()
    assert not off.tracing and off.dynamics_every == 0
    clock = _counter_clock()
    on = ttel.Telemetry.enabled(clock=clock, dynamics_every=3)
    assert on.tracing and on.dynamics_every == 3
    assert on.tracer.clock is clock
