"""PyTorch port vs the JAX package: the seeded storm replays.

The JAX ``tests/test_faults.py`` STORM (every site at once, seed 7) over
four prompts and two shared-prefix repeats, half of them streaming, on the
pool of 13 pages with a host tier of 16: the port run twice gives the same
injector log, aborted uids and survivor bytes, and so does the JAX engine
(with the same counters and trace fault instants); every survivor equals
its fault-free twin; both tiers drain to zero after ``drop_prefix_cache``.
"""
import numpy as np
import torch

from _torch_parity import (assert_fault_runs_match, fault_engines,
                           fault_outcomes)

torch.set_num_threads(1)

STORM = dict(seed=7, rates={"pool_alloc": 0.05, "step_nan": 0.03,
                            "lane_stall": 0.02, "disconnect": 0.02,
                            "host_store": 0.3, "host_corrupt": 0.3})


def _prompts(cfg):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size - 1, ln).astype(np.int32)
               for ln in (8, 8, 4, 8)]
    return prompts + [prompts[0].copy(), prompts[1].copy()]


def _serve(eng, prompts, stream=True):
    for i, p in enumerate(prompts):
        on = stream and i % 2 == 0
        eng.submit(p, gen_len=8, stream=on,
                   sink=(lambda ev: None) if on else None)
    eng.run()
    return eng


def _engines(cfg, params, plan):
    return fault_engines(cfg, params, pool_pages=13, host_pages=16,
                         prefix_cache=True, plan=plan,
                         sup=dict(watchdog_budget=6), supervise=True)


def test_chaos_replay_is_deterministic(tiny_cfg, tiny_params):
    prompts = _prompts(tiny_cfg)
    jeng, teng = (_serve(e, prompts) for e in _engines(tiny_cfg,
                                                       tiny_params, STORM))
    _, again = _engines(tiny_cfg, tiny_params, STORM)
    _serve(again, prompts)
    got = assert_fault_runs_match(jeng, teng)    # the port is JAX's storm
    assert teng.faults.total_fired > 0
    assert again.faults.log == teng.faults.log
    assert fault_outcomes(again) == got          # and replays itself
    assert {u for u, o in got.items() if o[0] is not None} == \
        {r.uid for r in again.done if r.fault is not None}
    _, clean = _engines(tiny_cfg, tiny_params, None)
    want = fault_outcomes(_serve(clean, prompts, stream=False))
    survivors = [u for u, (fault, canceled, shed, out) in got.items()
                 if fault is None and not canceled and not shed]
    assert survivors
    for u in survivors:
        assert got[u][3] == want[u][3], u        # the fault-free twin's
    for eng in (jeng, teng, again):
        assert eng.pool.used == eng.prefix.held_pages
        assert all(rc == 1 for rc in eng.pool.refcounts.values())
        assert eng.host_pool.used_pages == eng.prefix.host_held_pages
        eng.drop_prefix_cache()
        assert eng.pool.used == 0 and eng.host_pool.used_pages == 0
