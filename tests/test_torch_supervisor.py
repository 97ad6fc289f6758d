"""The port's supervisor: the invariant checker and chaos survivors against
a plain decode.

The checker passes a clean run (a check every iteration) and catches a
phantom page hold; a survivor of a stalled lane decodes to the bytes of a
dense ``DecodeSession`` through ``run`` and ``run_compiled``.  (The JAX
engine's side of every fault scenario: ``test_torch_faults_*.py``.)
"""
import numpy as np
import pytest
import torch

from _torch_parity import fault_engines, fault_outcomes, port_cfg
from repro_torch.core.strategy import SPACache
from repro_torch.dlm.session import DecodeSession
from repro_torch.serving.supervisor import InvariantViolation

torch.set_num_threads(1)


def _prompts(cfg, n, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size - 1, ln).astype(np.int32)
            for ln in lens[:n]]


def test_invariant_checker_catches_refcount_corruption(tiny_cfg,
                                                       tiny_params):
    _, eng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                           prefix_cache=True, supervise=True)
    eng.submit(_prompts(tiny_cfg, 1, [8])[0], gen_len=8)
    state = {"armed": True}

    def on_step(e):
        if state["armed"] and e._running:
            req = next(iter(e._running.values()))
            e.pool.retain([req.pages[0]])        # a phantom reader
            state["armed"] = False

    with pytest.raises(InvariantViolation,
                       match="page refcounts do not close"):
        eng.run(on_step=on_step)


def test_invariant_checker_passes_clean_run(tiny_cfg, tiny_params):
    _, eng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                           prefix_cache=True, host_pages=16, supervise=True)
    for p in _prompts(tiny_cfg, 4, [8, 8, 4, 8]):
        eng.submit(p, gen_len=8)
    eng.run()
    assert eng.stats.invariant_checks == eng.stats.steps > 0
    assert eng.stats.requests_done == 4
    assert eng.host_pool.used_pages == eng.prefix.host_held_pages


def test_survivor_matches_a_dense_decode_both_run_modes(tiny_cfg,
                                                        tiny_params):
    """A full-length request of a lane stalled at its first step (watchdog
    budget 3) decodes to the bytes of a dense session's ``run`` and
    ``run_compiled``."""
    prompt = np.asarray([3, 1, 4, 1], np.int32)
    _, teng = fault_engines(tiny_cfg, tiny_params, pool_pages=13,
                            prefix_cache=False,
                            plan=dict(at={"lane_stall": (0,)}),
                            sup=dict(watchdog_budget=3))
    teng.submit(prompt, gen_len=12)              # prompt + gen == canvas
    teng.run()
    got = fault_outcomes(teng)
    assert teng.stats.watchdog_fires == 1
    served = np.frombuffer(got[0][3], np.int32)
    strat = SPACache(rank=16, schedule="uniform", rho_peak=0.3,
                     refresh_interval=1)
    tcfg = port_cfg(tiny_cfg)
    ref = []
    for mode in ("run", "run_compiled"):
        sess = DecodeSession(teng.params, tcfg, strategy=strat,
                             spa_proxies=teng._proxies[teng.strategy],
                             device="cpu")
        sess.prefill(torch.from_numpy(prompt[None]).long(), gen_len=12)
        toks, _ = getattr(sess, mode)()
        ref.append(toks[0, 4:].numpy())
    np.testing.assert_array_equal(ref[0], ref[1])
    np.testing.assert_array_equal(served, ref[0])
