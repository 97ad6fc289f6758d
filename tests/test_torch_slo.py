"""PyTorch port vs the JAX package: SLO-aware scheduling
(``serving/slo.py`` and the engine's SLO paths).

``SLO``, ``SLOPolicy`` and ``StepClock`` answer as the JAX objects do on a
grid of inputs.  Two engine scenarios of the JAX ``tests/test_slo.py`` (an urgent request
boosted past a relaxed one, and the goodput / TTFT / TPOT accounting; the
third, shedding, is in ``test_torch_slo_shed.py``) run through the JAX
engine and the port's on the same weights and proxies under a
``StepClock``: the same SLO met / missed, the same outputs, the same
admission order and the same TTFT / TPOT percentiles.
"""
import itertools
import math

import numpy as np
import pytest
import torch

from repro.serving import slo as jslo

from _torch_parity import assert_slo_runs_match, slo_engines
from repro_torch.serving import slo as tslo

torch.set_num_threads(1)
INF = math.inf


class _R:
    """Duck-typed request for the policy."""

    def __init__(self, priority, slo, submitted_at, first_token_at):
        self.priority = priority
        self.slo = slo
        self.submitted_at = submitted_at
        self.first_token_at = first_token_at


def test_slo_policy_clock_match_jax():
    targets = [(INF, INF), (2.0, 10.0), (0.5, INF), (8.0, 60.0),
               (INF, 20.0)]
    for ttft, deadline in targets:
        t, j = tslo.SLO(ttft, deadline), jslo.SLO(ttft, deadline)
        for a, b in itertools.product((0.0, 0.5, 2.0, 9.0, 1e9),
                                      (0.0, 10.0, 20.5, 1e9)):
            assert t.met(a, b) == j.met(a, b)
    assert tslo.SLO() == tslo.SLO(INF, INF)
    for boost, frac, shed in itertools.product((0, 1, 2), (0.25, 0.5, 0.6),
                                               (True, False)):
        tp = tslo.SLOPolicy(boost=boost, urgency_frac=frac, shed=shed)
        jp = jslo.SLOPolicy(boost=boost, urgency_frac=frac, shed=shed)
        assert tp.shed == jp.shed
        for (ttft, deadline), prio, sub, first in itertools.product(
                targets + [(None, None)], (0, 3), (0.0, 2.5),
                (None, 1.0, 4.0)):
            tr = _R(prio, None if ttft is None
                    else tslo.SLO(ttft, deadline), sub, first)
            jr = _R(prio, None if ttft is None
                    else jslo.SLO(ttft, deadline), sub, first)
            for now in (0.0, 3.0, 6.0, 9.5, 25.0, 1e6):
                assert tp.ttft_slack(tr, now) == jp.ttft_slack(jr, now)
                assert tp.urgent(tr, now) == jp.urgent(jr, now)
                assert (tp.effective_priority(tr, now)
                        == jp.effective_priority(jr, now))
                for margin in (0.0, 1.5):
                    assert (tp.hopeless(tr, now, margin)
                            == jp.hopeless(jr, now, margin))
    tc, jc = tslo.StepClock(tick=2.0), jslo.StepClock(tick=2.0)
    for dt in (None, 0.5, None, 3.25):
        tc.advance(dt)
        jc.advance(dt)
        assert tc() == jc()


def test_engine_urgency_boost_reorders_queue(tiny_cfg, tiny_params):
    """The JAX scenario: a relaxed arrival, then an urgent one; the boost
    preempts a blocker and admits the urgent request first, in both."""
    rng = np.random.default_rng(1)
    pr = rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32)
    order = []
    for eng, clock, mod in slo_engines(tiny_cfg, tiny_params,
                                 dict(boost=2, urgency_frac=0.6)):
        for _ in range(2):
            eng.submit(pr, gen_len=12)
        uids = {}

        def on_step(e, clock=clock, mod=mod, uids=uids):
            clock.advance()
            if "relaxed" not in uids:
                uids["relaxed"] = e.submit(pr, gen_len=4,
                                           slo=mod.SLO(ttft=100.0))
            elif "urgent" not in uids:
                uids["urgent"] = e.submit(pr, gen_len=4,
                                          slo=mod.SLO(ttft=12.0))
        eng.run(on_step=on_step)
        by_uid = {r.uid: r for r in eng.done}
        assert by_uid[uids["urgent"]].started_at \
            < by_uid[uids["relaxed"]].started_at
        order.append(eng)
    jeng, teng = order
    assert_slo_runs_match(jeng, teng)
    assert teng.stats.preemptions >= 1 and teng.stats.slo_met == 4


def test_goodput_and_latency_accounting(tiny_cfg, tiny_params):
    """The JAX scenario: one committed token a step and a tick of 1 give
    TPOT exactly 1 and goodput counting only SLO-met completions."""
    res = []
    for eng, clock, mod in slo_engines(tiny_cfg, tiny_params, {}):
        rng = np.random.default_rng(2)
        eng.submit(rng.integers(0, tiny_cfg.vocab_size - 1, 4)
                   .astype(np.int32), gen_len=6,
                   slo=mod.SLO(ttft=4.0, deadline=20.0))
        eng.submit(rng.integers(0, tiny_cfg.vocab_size - 1, 4)
                   .astype(np.int32), gen_len=6)
        stats = eng.run(on_step=lambda e, clock=clock: clock.advance())
        res.append((eng, clock(), stats.goodput(clock())))
    (jeng, jt, jgood), (teng, tt, tgood) = res
    assert_slo_runs_match(jeng, teng)
    assert tt == jt and tgood == jgood == pytest.approx(2 / tt)
    stats = teng.stats
    assert stats.slo_met == 2 and stats.slo_missed == 0
    assert len(stats.ttft_latencies) == len(stats.tpot_latencies) == 2
    assert stats.percentiles()["tpot_p50"] == pytest.approx(1.0)
    assert stats.goodput(0.0) > 0
