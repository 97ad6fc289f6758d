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
    """Arguments of the engine parts not ported yet raise; their "off"
    values are accepted."""
    from repro_torch.models import transformer
    tcfg = port_cfg(tiny_cfg)
    params = transformer.init_params(tcfg, seed=0, device="cpu")
    TEngine(tcfg, params, device="cpu", prefix_cache=False, telemetry=None)
    for kw in (dict(prefix_cache=True), dict(host_pages=4),
               dict(slo_policy=object()), dict(supervise=True),
               dict(profiler=object())):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            TEngine(tcfg, params, device="cpu", **kw)


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
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--prefix-cache", "--host-pages",
                     "4"])
    err = capsys.readouterr().err
    assert "--prefix-cache" in err and "--host-pages" in err
