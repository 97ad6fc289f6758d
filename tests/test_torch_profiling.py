"""PyTorch port vs the JAX package: compute-path profiling and runtime
accounting of one decode session (``serving/profiling.py``,
``core/runtime.py``); the engine-level scenarios are in
``test_torch_profiling_engine.py``.

The scenarios of the JAX ``tests/test_profiling.py``:

* zero interference: a decode with a ``StepProfiler`` equals its twin
  without one, byte for byte, per strategy x run mode x kernel backend, and
  both equal the JAX XLA decode;
* exact tiling: the fenced segments share their ``perf_counter`` reads,
  so they sum to the recorded total;
* ``run_compiled`` records loop level only, ``sample_every`` skips steps,
  and the summary is safe when empty;
* trace accounting: a wrapper counts the first call at each signature,
  and a session's traces equal the JAX tracker's over the same decodes;
* the phase probes run on ``TorchBackend``; ``ProfileStore`` round-trips,
  and reads a file the JAX store wrote (and the other way round).

The JAX test's ``compile_s > steady_s`` is not carried over: eager torch
on the CPU compiles nothing at the first call.  ``steady_s`` is held to be
the minimum of the repetitions instead.
"""
import gc
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import runtime as jruntime
from repro.core.strategy import NoCache as JNoCache
from repro.core.strategy import SPACache as JSPACache
from repro.core.strategy import ValueProxyCache as JValue
from repro.dlm.session import DecodeSession as JSession
from repro.serving import profiling as jprofiling

from _torch_parity import port_cfg, port_params, port_proxies
from repro_torch.core import runtime
from repro_torch.core.strategy import NoCache as TNoCache
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.core.strategy import ValueProxyCache as TValue
from repro_torch.dlm.session import DecodeSession
from repro_torch.serving import profiling
from repro_torch.serving.profiling import (KernelPhaseProbes, ProfileStore,
                                           StepProfiler, time_compile_steady)
from repro_torch.serving.telemetry import MetricsRegistry, Telemetry

torch.set_num_threads(1)
GEN = 6
SPA = dict(rank=16, schedule="uniform", rho_peak=0.3)
STRATEGIES = {
    "spa": (JSPACache(**SPA), TSPACache(**SPA)),
    "value": (JValue(rho=0.3), TValue(rho=0.3)),
    "none": (JNoCache(), TNoCache()),
}


@pytest.fixture(scope="module")
def small(tiny_cfg, tiny_params):
    prompt = np.array(jax.random.randint(
        jax.random.PRNGKey(1), (2, 10), 0, tiny_cfg.vocab_size - 1))
    tcfg = port_cfg(tiny_cfg)
    return tiny_cfg, tiny_params, tcfg, port_params(tiny_params, tcfg), prompt


@pytest.fixture(scope="module")
def jax_decodes(small):
    """name -> (JAX XLA tokens, steps, the JAX proxies in the port's form)."""
    cfg, params, tcfg, _, prompt = small
    out = {}
    for name, (jstrat, _) in STRATEGIES.items():
        sess = JSession(params, cfg, strategy=jstrat)
        sess.prefill(prompt, gen_len=GEN)
        toks, info = sess.run()
        prox = (None if sess.spa_proxies is None
                else port_proxies(sess.spa_proxies, tcfg))
        out[name] = (np.asarray(toks), info["steps"], prox)
    return out


def _decode(small, jax_decodes, name, backend="cuda", mode="run",
            profiler=None):
    _, _, tcfg, tparams, prompt = small
    sess = DecodeSession(tparams, tcfg, strategy=STRATEGIES[name][1],
                         backend=backend, spa_proxies=jax_decodes[name][2],
                         device="cpu", profiler=profiler, label="test-lane")
    sess.prefill(torch.as_tensor(prompt), gen_len=GEN)
    toks, info = getattr(sess, mode)()
    return toks.numpy(), info["steps"]


# ---------------------------------------------------------------------------
# Zero interference, and the JAX decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["run", "run_compiled"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_profiling_on_is_byte_identical(small, jax_decodes, name, backend,
                                        mode):
    prof = StepProfiler(Telemetry.enabled(dynamics_every=0))
    t_off, s_off = _decode(small, jax_decodes, name, backend, mode)
    t_on, s_on = _decode(small, jax_decodes, name, backend, mode, prof)
    np.testing.assert_array_equal(t_on, t_off)
    assert s_on == s_off
    j_toks, j_steps, _ = jax_decodes[name]
    np.testing.assert_array_equal(t_on, j_toks)
    assert s_on == j_steps
    if mode == "run":
        assert prof.steps_observed == s_on
    else:
        assert prof.loops_observed == 1


# ---------------------------------------------------------------------------
# Segment tiling, loop-level observation, sampling, empty summaries
# ---------------------------------------------------------------------------

def test_step_segments_tile_total(small, jax_decodes):
    prof = StepProfiler(Telemetry.enabled(dynamics_every=0))
    _decode(small, jax_decodes, "spa", profiler=prof)
    assert prof.steps_observed > 0
    snap = prof.registry.snapshot()
    seg_sum = sum(
        snap[f'spa_profile_step_seconds{{segment="{seg}"}}']["sum"]
        for seg in StepProfiler.SEGMENTS)
    total = snap['spa_profile_step_seconds{segment="total"}']["sum"]
    assert seg_sum == pytest.approx(total, rel=1e-6, abs=1e-7)
    bd = prof.step_breakdown()
    assert set(StepProfiler.SEGMENTS) <= set(bd)
    assert sum(bd[s]["share"] for s in StepProfiler.SEGMENTS) \
        == pytest.approx(1.0, abs=1e-6)
    assert "step-time decomposition" in prof.format_summary()
    # the device track carries one slice per segment and step
    slices = [e for e in prof.tracer.events if e.cat == "device"]
    assert len(slices) == 3 * prof.steps_observed
    assert {e.pid for e in slices} == {profiling.PID_DEVICE}


def test_compiled_loop_records_loop_level_only(small, jax_decodes):
    prof = StepProfiler(Telemetry.enabled(dynamics_every=0))
    _, steps = _decode(small, jax_decodes, "spa", mode="run_compiled",
                       profiler=prof)
    snap = prof.registry.snapshot()
    assert snap["spa_profile_loop_seconds"]["count"] == 1
    assert snap["spa_profile_loop_steps_total"] == steps > 0
    assert not any(k.startswith("spa_profile_step_seconds") for k in snap)
    assert "compiled loops: n=1" in prof.format_summary()


def test_sample_every_skips_steps(small, jax_decodes):
    prof = StepProfiler(Telemetry.enabled(dynamics_every=0), sample_every=2)
    _, steps = _decode(small, jax_decodes, "spa", profiler=prof)
    assert 0 < prof.steps_observed < steps
    assert prof.steps_observed == (steps + 1) // 2


def test_profiler_summary_safe_when_empty():
    prof = StepProfiler()
    assert "no profiled steps" in prof.format_summary()
    assert prof.step_breakdown() == {}
    with prof.torch_trace() as tp:       # no trace dir: a no-op
        assert tp is None


def test_torch_trace_writes_a_chrome_trace(small, jax_decodes, tmp_path):
    prof = StepProfiler(torch_trace_dir=str(tmp_path / "tr"))
    with prof.torch_trace():
        _decode(small, jax_decodes, "spa", profiler=prof)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert prof.trace_path == str(tmp_path / "tr" / "trace.json")
    assert any(n and n.startswith("aten::") for n in names)


def test_time_compile_steady_takes_the_best_rep(monkeypatch):
    """First call apart, steady = the minimum of the repetitions (a fake
    clock gives each call a known duration)."""
    durations = iter([0.5, 0.25, 0.125, 0.375])   # exact in binary
    now = [0.0]

    def clock():
        return now[0]

    def fn(x):
        now[0] += next(durations)
        return x * 2

    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    compile_s, steady_s = time_compile_steady(fn, torch.ones(4), reps=3)
    assert (compile_s, steady_s) == (0.5, 0.125)
    c, s = time_compile_steady(lambda x: x + 1, torch.ones(8), reps=2)
    assert c >= 0 and s >= 0


# ---------------------------------------------------------------------------
# Trace accounting
# ---------------------------------------------------------------------------

def test_compile_tracker_counts_traces_exactly():
    """The JAX test's three calls (two of one shape, one of another), with
    the signature the caller gives: two traces, one lane."""
    tracker = runtime.CompileTracker()
    f = tracker.wrap(lambda x: x * 2, name="f", lane="laneA",
                     signature=lambda x: tuple(x.shape))
    f(torch.ones(2))
    f(torch.ones(2))                       # seen: no trace
    f(torch.ones(3))                       # new signature: one trace
    assert tracker.trace_count("f") == 2
    assert tracker.trace_count() == 2
    assert tracker.top_retraced(1) == [("laneA", 2)]
    snap = tracker.snapshot()
    assert snap["traces"] == {"f": 2}
    assert snap["live_executables"] == runtime.live_executable_count()
    g = tracker.wrap(lambda: 1, name="g")  # no signature: the first call
    g(), g()
    assert tracker.trace_count("g") == 1
    tracker.reset()
    assert tracker.snapshot()["traces"] == {}
    f(torch.ones(3))                       # a wrapper keeps its signatures
    assert tracker.trace_count() == 0


@pytest.mark.parametrize("mode", ["run", "run_compiled"])
@pytest.mark.parametrize("name", ["spa", "none"])
def test_session_trace_counts_equal_jax(small, jax_decodes, name, mode):
    """Two identical decodes through one session: the port's trace counts
    equal the JAX tracker's (one trace of the step or the loop; the second
    decode adds none)."""
    cfg, params, tcfg, tparams, prompt = small
    counts = []
    for tracker, make in (
            (jruntime.compile_tracker(),
             lambda: JSession(params, cfg, strategy=STRATEGIES[name][0],
                              label="L")),
            (runtime.compile_tracker(),
             lambda: DecodeSession(tparams, tcfg,
                                   strategy=STRATEGIES[name][1],
                                   spa_proxies=jax_decodes[name][2],
                                   device="cpu", label="L"))):
        tracker.reset()
        sess = make()
        seen = []
        for _ in range(2):
            sess.prefill(prompt, gen_len=GEN)
            getattr(sess, mode)()
            seen.append((dict(tracker.traces), dict(tracker.lane_traces)))
        counts.append(seen)
    assert counts[1] == counts[0]
    fn = "serve_step" if mode == "run" else "decode_loop"
    assert counts[1][1] == ({fn: 1}, {"L": 1})


def test_kernel_library_counts_as_build_event_and_executable(monkeypatch,
                                                             tmp_path):
    """``_lib.load`` reports an nvcc build as one ``backend_compile`` event
    and registers the library as a live executable; a library found built
    loads with no event.  (nvcc and the card are stood in for.)"""
    from repro_torch.kernels import _lib

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    def fake_build(lib_path, sources):
        lib_path.write_bytes(b"")
        return "built"

    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_build", fake_build)
    monkeypatch.setattr(_lib.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_lib, "_state", dict(_lib._state, lib=None))
    tracker = runtime.compile_tracker()
    live0 = runtime.live_executable_count()
    for built in (True, False):
        tracker.reset()
        lib = _lib.load()
        assert runtime.live_executable_count() == live0 + 1
        assert tracker.snapshot()["event_counts"] == (
            {"backend_compile": 1} if built else {})
        assert _lib.build_log() == "built"
        del lib
        _lib._state["lib"] = None          # unloaded: no longer live
        gc.collect()
        assert runtime.live_executable_count() == live0
    assert runtime.drop_executables() == 0   # no CUDA graph tracked


def test_tracked_graphs_are_counted_and_dropped(monkeypatch):
    """A tracked CUDA graph counts as one live executable, and
    ``drop_executables`` resets and forgets it; other tracked objects (the
    kernel library) stay."""
    class Library:
        pass

    class Graph:
        was_reset = False

        def reset(self):
            self.was_reset = True

    # a CPU build of torch cannot instantiate CUDAGraph: stand in for it
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    live0 = runtime.live_executable_count()
    lib, graph = Library(), Graph()
    assert runtime.track_executables(lib) is lib
    runtime.track_executables(graph)
    assert runtime.live_executable_count() == live0 + 2
    assert runtime.drop_executables("test") == 1
    assert graph.was_reset
    assert runtime.live_executable_count() == live0 + 1


# ---------------------------------------------------------------------------
# Kernel-phase probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_kernel_phase_probes_smoke(small, backend):
    _, _, tcfg, _, _ = small
    reg = MetricsRegistry()
    probes = KernelPhaseProbes(tcfg, strategy=STRATEGIES["spa"][1],
                               backend=backend, batch=1, seq=32,
                               n_selected=8, page=8, registry=reg,
                               device="cpu")
    out = probes.run(reps=2)
    assert set(out) == {"identify", "gather", "attend", "scatter",
                        "page_gather"}
    for rec in out.values():
        assert rec["compile_s"] > 0 and rec["steady_s"] > 0
        assert rec["launches"] == {}          # plain versions on the CPU
    snap = reg.snapshot()
    assert f'spa_profile_phase_seconds{{backend="{backend}",' \
           f'phase="attend"}}' in snap
    out2 = KernelPhaseProbes(tcfg, strategy=TNoCache(), batch=1, seq=32,
                             n_selected=8, page=8, device="cpu").run(reps=1)
    assert "identify" not in out2
    # the probes' shapes are the JAX probes'
    jprobes = jprofiling.KernelPhaseProbes(
        small[0], strategy=STRATEGIES["spa"][0], batch=1, seq=32,
        n_selected=8, page=8)
    for phase, (fn, args) in probes._build().items():
        jargs = jprobes._build()[phase][1]
        assert [tuple(a.shape) for a in args] == \
            [tuple(a.shape) for a in jargs], phase
        ref = jax.tree.leaves(jprobes._build()[phase][0](*jargs))
        got = [t for t in jax.tree.leaves(
            fn(*args), is_leaf=lambda x: isinstance(x, torch.Tensor))]
        assert [tuple(t.shape) for t in got] == \
            [tuple(r.shape) for r in ref], phase


# ---------------------------------------------------------------------------
# ProfileStore
# ---------------------------------------------------------------------------

def test_profile_store_round_trip(tmp_path):
    path = tmp_path / "profiles.json"
    store = ProfileStore(str(path))
    assert len(store) == 0
    store.put({"steady_us": 12.5}, kind="kernel", kernel="gather_norm",
              shape="b2n256", backend="cuda", block="bq512")
    store.save()
    again = ProfileStore(str(path))
    rec = again.get(kernel="gather_norm", shape="b2n256", backend="cuda",
                    block="bq512", kind="kernel")   # key order-free
    assert rec is not None and rec["steady_us"] == 12.5
    assert rec["key"]["kernel"] == "gather_norm"
    path.write_text("{not json")
    assert len(ProfileStore(str(path))) == 0
    assert profiling.default_profile_path() == \
        jprofiling.default_profile_path()


def test_profile_store_crosses_packages(tmp_path):
    """A file the JAX store wrote reads in the port, and the port's file
    is byte for byte the JAX store's for the same records."""
    recs = [({"steady_us": 3.25, "compile_s": 0.5},
             dict(kind="kernel", kernel="sparse_attention", shape="b4n512",
                  backend="xla")),
            ({"best": [1, 2]}, dict(kind="hillclimb", arch="llada-8b",
                                    mesh="single", variant=0))]
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jstore, tstore = (jprofiling.ProfileStore(str(jpath)),
                      ProfileStore(str(tpath)))
    for rec, key in recs:
        jstore.put(rec, **key)
        tstore.put(rec, **key)
    jstore.save()
    tstore.save()
    assert tpath.read_bytes() == jpath.read_bytes()
    from_jax = ProfileStore(str(jpath))
    assert from_jax.records == jstore.records
    for rec, key in recs:
        assert jprofiling.ProfileStore(str(tpath)).get(**key) == \
            from_jax.get(**key)
