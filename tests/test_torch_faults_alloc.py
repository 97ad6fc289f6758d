"""PyTorch port vs the JAX package: transient allocation faults.

The JAX ``tests/test_faults.py`` ``pool_alloc`` scenarios through both
engines (same weights and proxies): a transient failure retried with
backoff on the step clock and invisible in the outputs; a hard failure
aborted past the retry budget with nothing leaked; and (port and JAX)
``run_online`` under a plan whose backoff advances the idle tick.  Each
compares the injector log, the done / faulted uids, the outputs, the fault
counters and the trace's fault instants (``assert_fault_runs_match``).
"""
import threading

import numpy as np
import torch

from _torch_parity import (assert_fault_runs_match, fault_engines,
                           fault_outcomes)

torch.set_num_threads(1)


def _prompts(cfg, n, lens=8, seed=11):
    rng = np.random.default_rng(seed)
    lens = [lens] * n if isinstance(lens, int) else lens
    return [rng.integers(0, cfg.vocab_size - 1, ln).astype(np.int32)
            for ln in lens[:n]]


def _serve(engines, prompts, **submit):
    for eng in engines:
        for p in prompts:
            eng.submit(p, gen_len=8, **submit)
        eng.run()
    return engines


def test_alloc_fault_transient_retry_completes(tiny_cfg, tiny_params):
    """The first admission allocation fails once: the request backs off a
    step and completes; the outputs equal a fault-free run's."""
    prompts = _prompts(tiny_cfg, 3)
    _, clean = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                             prefix_cache=True, supervise=True)
    want = fault_outcomes(_serve([clean], prompts)[0])
    jeng, teng = _serve(fault_engines(
        tiny_cfg, tiny_params, pool_pages=13, prefix_cache=True,
        plan=dict(at={"pool_alloc": (0,)})), prompts)
    got = assert_fault_runs_match(jeng, teng)
    assert teng.stats.alloc_faults == 1
    assert teng.stats.requests_faulted == 0
    assert teng.stats.requests_done == 3
    assert got == want                           # the retry is invisible
    assert teng.pool.used == teng.prefix.held_pages


def test_alloc_fault_hard_aborts_past_retry_budget(tiny_cfg, tiny_params):
    """Every allocation fails: each request is tried 1 + 2 times and
    aborted ("aborted" events), and both pools end empty."""
    events = {}
    jeng, teng = fault_engines(
        tiny_cfg, tiny_params, pool_pages=13, prefix_cache=True,
        plan=dict(rates={"pool_alloc": 1.0}),
        sup=dict(max_alloc_retries=2))
    for eng in (jeng, teng):
        got = events[eng] = []
        for p in _prompts(tiny_cfg, 2):
            eng.submit(p, gen_len=8, stream=True, sink=got.append)
        eng.run()                                # must terminate
    assert_fault_runs_match(jeng, teng)
    assert teng.stats.requests_faulted == 2
    assert teng.stats.requests_done == 0
    assert all(r.fault == "pool_alloc" for r in teng.done)
    assert [(e.kind, e.uid, e.step) for e in events[teng]] == \
        [(e.kind, e.uid, e.step) for e in events[jeng]]
    assert [e.kind for e in events[teng]] == ["aborted", "aborted"]
    assert teng.stats.alloc_faults == 2 * 3      # first try + 2 retries
    assert teng.pool.used == teng.prefix.held_pages == 0
    assert not teng.pool.refcounts


def test_run_online_backoff_advances_the_idle_tick(tiny_cfg, tiny_params):
    """``run_online`` under a plan whose first two admission allocations
    fail: while the only request backs off, the loop ticks the step clock
    with no lane step (1, then 2 steps of backoff), then serves it; both
    engines count the same steps and give the same output.  The request's
    "done" event stops the loop."""
    prompt = _prompts(tiny_cfg, 1)[0]
    jeng, teng = fault_engines(
        tiny_cfg, tiny_params, pool_pages=13, prefix_cache=False,
        plan=dict(at={"pool_alloc": (0, 1)}))
    steps = {}
    for eng in (jeng, teng):
        stop = threading.Event()
        seen = steps[eng] = []

        def sink(ev, stop=stop, eng=eng, seen=seen):
            seen.append((ev.kind, ev.step))
            if ev.kind == "done":
                stop.set()
        eng.submit(prompt, gen_len=8, stream=True, sink=sink)
        eng.run_online(stop, idle_wait=0.001)
    assert_fault_runs_match(jeng, teng)
    assert teng.stats.alloc_faults == 2 and teng.stats.requests_done == 1
    first = [step for kind, step in steps[teng] if kind == "token"][0]
    # 3 idle ticks (backoff 1 then 2) before the first served step
    assert first == 4 and steps[teng] == steps[jeng]
    assert teng.pool.used == 0
