"""PyTorch port vs the JAX package: the SLO policy's shedding.

The JAX ``tests/test_slo.py`` scenario of a hopeless request: two
priority-5 blockers hold both slots for about 12 steps, and an arrival at
step 1 with a TTFT target of 3 steps can never start in time.  Under
``SLOPolicy()`` both engines shed it (no output, nothing leaked); without a
policy both serve it late.  The JAX engine and the port's (same weights
and proxies, each under its own ``StepClock``) give the same shed uid, SLO
met / missed, outputs, times and TTFT / TPOT percentiles.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_slo_runs_match, slo_engines

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", [{}, None], ids=["slo", "fifo"])
def test_engine_sheds_hopeless_request(tiny_cfg, tiny_params, policy):
    """The JAX scenario: two priority-5 blockers hold both slots for about
    12 steps; an arrival at step 1 with TTFT 3 is shed under the policy
    (and served late without one), in both engines alike."""
    rng = np.random.default_rng(0)
    blockers = [rng.integers(0, tiny_cfg.vocab_size - 1, 4)
                .astype(np.int32) for _ in range(2)]
    late = rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32)
    runs = []
    for eng, clock, mod in slo_engines(tiny_cfg, tiny_params, policy):
        for p in blockers:
            eng.submit(p, gen_len=12, priority=5)
        doomed = {}

        def on_step(e, clock=clock, mod=mod, doomed=doomed):
            clock.advance()
            if not doomed and e.stats.steps >= 1:
                doomed["uid"] = e.submit(late, gen_len=4,
                                         slo=mod.SLO(ttft=3.0))
        eng.run(on_step=on_step)
        runs.append((eng, doomed["uid"]))
    (jeng, juid), (teng, tuid) = runs
    assert juid == tuid
    assert_slo_runs_match(jeng, teng)
    shed = {r.uid for r in teng.done if r.shed}
    if policy is None:
        assert not shed and teng.stats.requests_done == 3
        assert teng.stats.slo_missed == 1
    else:
        assert shed == {tuid} and teng.stats.requests_done == 2


