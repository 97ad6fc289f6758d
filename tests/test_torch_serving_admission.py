"""PyTorch port vs the JAX package: the ServingEngine, part 2 (admission).

As in ``tests/test_torch_serving.py``: both engines serve the same requests
and must give identical outputs per uid, equal engine counters and a
drained pool.  Scenarios mirror ``test_oversubscribed_pool_completes`` and
``test_preemption_engine_byte_identical`` (``tests/test_serving.py``) and
``test_continuous_batching_byte_identical``
(``tests/test_strategy_parity.py``), each with the port's own version of
the property it checks.
"""
import jax
import numpy as np
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import SPACache as JSPACache
from repro.models import transformer as jt

from _torch_parity import assert_engines_match, serve_both
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.serving.engine import ServingEngine as TEngine

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16


def _strategies(**kw):
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3, **kw)
    return JSPACache(**spec), TSPACache(**spec)


def test_oversubscribed_pool_completes_like_jax(tiny_cfg, tiny_params):
    """Twice the pool's pages in demand: requests wait for pages and all
    complete, as in the JAX engine."""
    rng = np.random.default_rng(3)
    n_log = CANVAS // PAGE
    reqs = [(rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32),
             CANVAS - 8, 0) for _ in range(6)]
    jeng, teng = serve_both(tiny_cfg, tiny_params, reqs,
                            strategies=_strategies(), max_batch=2,
                            canvas_len=CANVAS, pool_pages=1 + 2 * n_log,
                            page_size=PAGE)
    assert len(reqs) * n_log >= 2 * teng.pool.capacity
    assert_engines_match(jeng, teng)
    assert teng.stats.requests_done == 6
    assert teng.stats.admission_stalls > 0
    assert all((r.output != tiny_cfg.mask_id).all() for r in teng.done)
    assert 0.0 < teng.stats.steady_pool_util <= teng.stats.peak_pool_util
    assert teng.stats.peak_pool_util <= 1.0


def _preemption_run(tiny_cfg, tiny_params, pool_pages, max_batch):
    rng = np.random.default_rng(4)
    smalls = [rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32)
              for _ in range(2)]
    big = rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32)

    def on_step(engine, submit):
        if engine.stats.steps == 2:          # once per engine
            submit(big, 8, 5)

    return serve_both(tiny_cfg, tiny_params, [(p, 4, 0) for p in smalls],
                      strategies=_strategies(refresh_interval=1),
                      on_step=on_step, max_batch=max_batch,
                      canvas_len=CANVAS, pool_pages=pool_pages,
                      page_size=PAGE)


def test_preemption_matches_jax_and_roomy_twin(tiny_cfg, tiny_params):
    """A priority-5 arrival on a tight pool preempts running requests in
    both engines alike; the preempted requests still decode as they do
    on a roomy pool where nothing is preempted (refresh_interval=1, so a
    resume's re-prefill is the refresh the twin runs anyway)."""
    jeng, teng = _preemption_run(tiny_cfg, tiny_params, 1 + 4, 2)
    tight = assert_engines_match(jeng, teng)
    assert teng.stats.preemptions > 0
    assert any(r.preemptions > 0 for r in teng.done)
    roomy = TEngine(teng.cfg, teng.params, strategy=teng.strategy,
                    device="cpu", max_batch=3, canvas_len=CANVAS,
                    pool_pages=1 + 3 * (CANVAS // PAGE), page_size=PAGE)
    roomy._proxies = teng._proxies
    big = next(r for r in teng.done if r.priority == 5)
    for r in sorted(teng.done, key=lambda r: r.uid):
        if r is not big:
            roomy.submit(r.prompt, gen_len=r.gen_len)

    def arrive(e):
        if e.stats.steps == 2:
            e.submit(big.prompt, gen_len=big.gen_len, priority=5)

    roomy.run(on_step=arrive)
    assert roomy.stats.preemptions == 0
    assert {r.uid: r.output.tolist() for r in roomy.done} == \
        {uid: out.tolist() for uid, out in tight.items()}


def test_continuous_batching_matches_jax_and_static():
    """Unequal gen lengths force mid-loop swaps on the dense engine: the
    outputs equal the JAX engine's and the port's static batching."""
    cfg = reduced(get_arch("internlm2-1.8b"))
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size - 1, 8).astype(np.int32), g, 0)
            for g in (4, 7, 5, 6, 4)]
    jeng, teng = serve_both(cfg, params, reqs, strategies=_strategies(),
                            max_batch=2, canvas_len=24, continuous=True)
    cont = assert_engines_match(jeng, teng)
    assert teng.stats.swaps > 0
    static = TEngine(teng.cfg, teng.params, strategy=teng.strategy,
                     device="cpu", max_batch=2, canvas_len=24,
                     continuous=False)
    static._proxies = teng._proxies
    for p, g, _ in reqs:
        static.submit(p, gen_len=g)
    static.run()
    assert static.stats.swaps == 0
    for r in static.done:
        np.testing.assert_array_equal(r.output, cont[r.uid])


def test_cancel_queued_and_running(tiny_cfg, tiny_params):
    """cancel() aborts a queued and a running request; their pages return
    and the others complete."""
    from _torch_parity import port_cfg, port_params
    tcfg = port_cfg(tiny_cfg)
    eng = TEngine(tcfg, port_params(tiny_params, tcfg),
                  strategy=TSPACache(rank=16), device="cpu", max_batch=2,
                  canvas_len=CANVAS, pool_pages=1 + 2 * (CANVAS // PAGE),
                  page_size=PAGE)
    rng = np.random.default_rng(5)
    uids = [eng.submit(rng.integers(0, tcfg.vocab_size - 1, 8)
                       .astype(np.int32), gen_len=8) for _ in range(3)]
    assert eng.cancel(uids[2])            # still queued

    def on_step(e):
        if e.stats.steps == 1:
            assert e.cancel(uids[0])      # running

    eng.run(on_step=on_step)
    assert not eng.cancel(uids[1])        # finished
    by_uid = {r.uid: r for r in eng.done}
    assert by_uid[uids[0]].canceled and by_uid[uids[0]].output is None
    assert by_uid[uids[2]].canceled and by_uid[uids[1]].output is not None
    assert eng.stats.requests_canceled == 2
    assert eng.stats.requests_done == 1
    assert eng.pool.available == eng.pool.capacity
