"""PyTorch port vs the JAX package: the paged ServingEngine, part 1.

The port's engine and the JAX engine serve the same requests with the same
weights and singular proxies (carried across as numpy); the port runs
``CudaBackend``, whose wrappers take their plain versions on the CPU.  The
bar: identical outputs for every uid, equal ``steps``, ``swaps``,
``preemptions``, ``requests_done`` and ``admission_stalls``, and a drained
pool.  Scenarios mirror ``tests/test_serving.py`` (paged vs dense engine,
mixed gen_len), here together with the port's own version of the property
each of them checks; ``tests/test_torch_serving_admission.py`` holds the
admission scenarios.  Also the offline CLI, in-process.
"""
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache

from _torch_parity import assert_engines_match, port_cfg, serve_both
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16


def _strategies(**kw):
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3, **kw)
    return JSPACache(**spec), TSPACache(**spec)


def _kw(pool_pages, max_batch=2):
    return dict(max_batch=max_batch, canvas_len=CANVAS, pool_pages=pool_pages,
                page_size=PAGE)


def test_paged_engine_matches_jax_and_dense(tiny_cfg, tiny_params):
    """Full-length requests: the port's paged engine equals the JAX paged
    engine, and equals the port's dense engine."""
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32),
             CANVAS - 8, 0) for _ in range(4)]
    jeng, teng = serve_both(tiny_cfg, tiny_params, reqs,
                            strategies=_strategies(),
                            **_kw(1 + 2 * (CANVAS // PAGE)))
    paged = assert_engines_match(jeng, teng)
    assert teng.stats.swaps > 0
    dense = TEngine(port_cfg(tiny_cfg), teng.params, strategy=teng.strategy,
                    device="cpu", **_kw(0))
    dense._proxies = teng._proxies
    for p, g, _ in reqs:
        dense.submit(p, gen_len=g)
    dense.run()
    assert {r.uid for r in dense.done} == set(paged)
    for r in dense.done:
        np.testing.assert_array_equal(r.output, paged[r.uid])


def test_paged_mixed_gen_len_matches_jax_and_alone(tiny_cfg, tiny_params):
    """Requests of different gen_len share a lane without padding; each
    output equals the JAX engine's and the port serving it alone."""
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32),
             g, 0) for g in (4, 8, 12, 4)]
    jeng, teng = serve_both(tiny_cfg, tiny_params, reqs,
                            strategies=_strategies(),
                            **_kw(1 + 3 * (CANVAS // PAGE)))
    together = assert_engines_match(jeng, teng)
    for uid, (p, g, _) in enumerate(reqs):
        alone = TEngine(teng.cfg, teng.params, strategy=teng.strategy,
                        device="cpu", **_kw(1 + 3 * (CANVAS // PAGE)))
        alone._proxies = teng._proxies
        alone.submit(p, gen_len=g)
        alone.run()
        np.testing.assert_array_equal(alone.done[0].output, together[uid])


def test_engine_refuses_parts_that_wait(tiny_cfg):
    """Every argument of the JAX engine is ported: the "off" values, the
    SLO policy, telemetry, fault plan, supervisor and (now) a profiler,
    which every lane session gets.  An unknown argument still raises."""
    from repro_torch.models import transformer
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.profiling import StepProfiler
    from repro_torch.serving.slo import SLOPolicy
    from repro_torch.serving.telemetry import Telemetry
    tcfg = port_cfg(tiny_cfg)
    params = transformer.init_params(tcfg, seed=0, device="cpu")
    TEngine(tcfg, params, device="cpu", fault_plan=None, supervise=False,
            profiler=None)
    eng = TEngine(tcfg, params, device="cpu", slo_policy=SLOPolicy(),
                  telemetry=Telemetry.enabled(), fault_plan=FaultPlan(),
                  supervise=True)
    assert eng.slo_policy is not None and eng.telemetry.tracing
    assert eng.faults is not None and eng.supervisor is not None
    prof = StepProfiler()
    eng = TEngine(tcfg, params, device="cpu", canvas_len=16, profiler=prof)
    eng.submit(np.arange(1, 9, dtype=np.int32), gen_len=8)
    eng.run()
    (sess,) = eng._sessions.values()
    assert sess.profiler is prof and prof.steps_observed == eng.stats.steps
    with pytest.raises(TypeError, match="bogus"):
        TEngine(tcfg, params, device="cpu", bogus=1)


def test_serve_cli_paged_in_process(capsys):
    """The offline CLI, paged, on the CPU: every request is served."""
    assert tserve.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                        "--requests", "5", "--gen-len", "6", "--canvas",
                        "24", "--max-batch", "2", "--pool-pages", "10",
                        "--page-size", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out
    assert "pool: peak" in out


def test_serve_cli_names_flags_that_wait(capsys):
    """No flag waits any more: ``--profile`` and ``--ckpt`` are accepted
    (``--ckpt`` of a missing file fails opening it, not in the parser), and
    the one flag the parser refuses is ``--torch-trace-dir`` without
    ``--profile``, named in the error."""
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--prefix-cache", "--supervise",
                     "--slo-ttft", "4", "--torch-trace-dir", "t"])
    error = capsys.readouterr().err.strip().splitlines()[-1]
    assert "--torch-trace-dir" in error and "--profile" in error
    assert "--prefix-cache" not in error    # ported: accepted
    assert "--slo-ttft" not in error and "--supervise" not in error
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        tserve.main(["--device", "cpu", "--profile", "--ckpt",
                     "missing.npz"])


def test_serve_cli_slo_trace_and_metrics(capsys, tmp_path):
    """``--slo-ttft 50 --slo-deadline 200 --trace-out --metrics``: the
    summary has the SLO line and the registry dump, and the trace file
    loads as a Chrome trace with request and engine-phase spans."""
    import json
    trace = tmp_path / "trace.json"
    assert tserve.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                        "--requests", "4", "--gen-len", "6", "--canvas",
                        "24", "--max-batch", "2", "--pool-pages", "10",
                        "--page-size", "4", "--slo-ttft", "50",
                        "--slo-deadline", "200", "--trace-out", str(trace),
                        "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "SLO 4 met / 0 missed, 0 shed, 0 canceled" in out
    assert "spa_engine_steps_total" in out
    assert f"-> {trace}" in out
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"request", "queued", "running", "dispatch", "host_overlap",
            "host_sync"} <= names
