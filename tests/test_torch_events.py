"""PyTorch port vs the JAX package: per-token event streams and the debug
views of the serving engine.

Both engines serve one Poisson arrival trace of the JAX serving bench's
online classes (``benchmarks/bench_serving.py:_online_classes``:
interactive prompt 6 + gen 6 with TTFT 8 and deadline 60, batch prompt 8 +
gen 16 with deadline 400) under a ``StepClock`` and
``SLOPolicy(boost=2, urgency_frac=0.6)``, on the bench's engine shape
(canvas 32, pages of 4, prefix index on, SPACache) cut to 2 slots and a
pool of 2 canvases + 2, with arrivals at 4 a step so that the policy both
sheds and preempts.  Every
event (kind, uid, step, positions, tokens; not the clock stamp) is the
same in both, a preempted-then-resumed request streams each gen position
exactly once, ``cancel`` emits "canceled" for a queued and a running
request, and ``request_states`` / ``pool_debug_state`` have the JAX
engine's keys (``pool_debug_state``'s ``live_executables`` included).
"""
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache
from repro.serving import slo as jslo

from _torch_parity import engine_pair, port_cfg
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.serving import slo as tslo

torch.set_num_threads(1)
PAGE, CANVAS, SLOTS = 4, 32, 2
# the strategy's own refresh schedule: a JAX refresh is an eager prefill,
# ~0.7 s a step on the CPU, and the streams do not need one every step
SPEC = dict(rank=16, schedule="uniform", rho_peak=0.3)


def poisson_trace(vocab, slo_mod, n=12, rate=4.0, seed=11):
    """``_poisson_arrivals(n, rate, seed)`` of the JAX bench: (arrival
    time, index, prompt, gen, SLO) with exponential gaps and the online
    classes drawn 60 / 40."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        if rng.random() < 0.6:
            p_len, gen, slo = 6, 6, slo_mod.SLO(ttft=8.0, deadline=60.0)
        else:
            p_len, gen, slo = 8, 16, slo_mod.SLO(deadline=400.0)
        out.append((t, i, rng.integers(0, vocab - 1, p_len)
                    .astype(np.int32), gen, slo))
    return out


def serve_trace(eng, clock, arrivals):
    """The JAX bench's ``_serve_online``: feed each arrival once the clock
    reaches it, one tick per engine step, idle gaps jumping to the next
    arrival.  Every request streams into ``events``."""
    events = []
    eng.event_sink = events.append
    pending = sorted(arrivals, key=lambda a: (a[0], a[1]))

    def feed(e):
        while pending and pending[0][0] <= clock.t + 1e-9:
            _, _, prompt, gen, slo = pending.pop(0)
            e.submit(prompt, gen, slo=slo, stream=True)

    def on_step(e):
        clock.advance()
        feed(e)

    feed(eng)
    while True:
        eng.run(max_steps=100_000, on_step=on_step)
        if not pending:
            break
        clock.t = max(clock.t, pending[0][0])
        feed(eng)
    return events


def _engines(cfg, params, **kw):
    jclock, tclock = jslo.StepClock(), tslo.StepClock()
    jeng, teng = engine_pair(
        cfg, params, (JSPACache(**SPEC), TSPACache(**SPEC)),
        jextra=dict(clock=jclock,
                    slo_policy=jslo.SLOPolicy(boost=2, urgency_frac=0.6)),
        textra=dict(clock=tclock,
                    slo_policy=tslo.SLOPolicy(boost=2, urgency_frac=0.6)),
        max_batch=SLOTS, canvas_len=CANVAS, page_size=PAGE,
        pool_pages=SLOTS * (CANVAS // PAGE) + 2, prefix_cache=True, **kw)
    return (jeng, jclock), (teng, tclock)


@pytest.fixture(scope="module")
def poisson_runs(tiny_cfg, tiny_params):
    runs = []
    for (eng, clock), mod in zip(_engines(tiny_cfg, tiny_params),
                                 (jslo, tslo)):
        events = serve_trace(eng, clock,
                             poisson_trace(tiny_cfg.vocab_size, mod))
        runs.append((eng, events))
    return runs


def _key(ev):
    return (ev.kind, ev.uid, ev.step, tuple(int(p) for p in ev.positions),
            tuple(int(t) for t in ev.tokens))


def test_event_streams_match_jax(poisson_runs):
    (jeng, jev), (teng, tev) = poisson_runs
    assert teng.stats.requests_shed >= 1, "the trace shed nothing"
    assert teng.stats.preemptions >= 1, "the trace preempted nothing"
    assert [_key(e) for e in tev] == [_key(e) for e in jev]
    assert ({r.uid for r in teng.done if r.shed}
            == {r.uid for r in jeng.done if r.shed})
    for name in ("steps", "preemptions", "requests_shed", "slo_met",
                 "slo_missed", "requests_done"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.pool.used == teng.prefix.held_pages \
        == jeng.prefix.held_pages


def test_streams_cover_each_position_once(poisson_runs):
    """Every completed request's token events cover each gen position
    exactly once and equal its output, a preempted-then-resumed one
    included; shed requests end in one "shed" event."""
    _, (teng, events) = poisson_runs
    by_uid = {}
    for ev in events:
        by_uid.setdefault(ev.uid, []).append(ev)
    resumed = 0
    for r in teng.done:
        evs = by_uid[r.uid]
        assert [e.kind for e in evs].count("token") == len(evs) - 1
        if r.shed:
            assert evs[-1].kind == "shed" and r.output is None
            continue
        assert evs[-1].kind == "done"
        assert evs[-1].tokens == tuple(int(t) for t in r.output)
        pos = [p for e in evs[:-1] for p in e.positions]
        assert sorted(pos) == list(range(r.gen_len))
        stream = dict(zip(pos, (t for e in evs[:-1] for t in e.tokens)))
        np.testing.assert_array_equal(
            [stream[i] for i in range(r.gen_len)], r.output)
        resumed += r.preemptions > 0
    assert resumed >= 1, "no preempted request completed"


def test_cancel_emits_canceled(tiny_cfg, tiny_params):
    """A queued and a running request, canceled: one "canceled" event each
    (after the running one's token events), no output, pages freed."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine
    cfg = port_cfg(tiny_cfg)
    eng = ServingEngine(cfg, transformer.init_params(cfg, seed=0,
                                                     device="cpu"),
                        max_batch=1, canvas_len=CANVAS, page_size=PAGE,
                        pool_pages=2 * (CANVAS // PAGE) + 1,
                        strategy=TSPACache(**SPEC), device="cpu")
    rng = np.random.default_rng(3)
    events = []
    uids = [eng.submit(rng.integers(0, cfg.vocab_size - 1, 6), 12,
                       sink=events.append) for _ in range(2)]
    assert eng.cancel(uids[1])          # queued
    eng.run(on_step=lambda e: e.stats.steps == 2 and e.cancel(uids[0]))
    kinds = {u: [ev.kind for ev in events if ev.uid == u] for u in uids}
    assert kinds[uids[1]] == ["canceled"]
    assert kinds[uids[0]][-1] == "canceled"
    assert set(kinds[uids[0]][:-1]) <= {"token"}
    assert eng.stats.requests_canceled == 2
    assert all(r.canceled and r.output is None for r in eng.done)
    assert eng.pool.used == 0
    assert not eng.cancel(uids[0]) and not eng.cancel(99)


def _keys(x):
    """The nested key structure of a JSON-able view (lists by their
    first element)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return None


def test_debug_views_have_jax_keys(tiny_cfg, tiny_params):
    """Mid-run, with requests queued, running and done, and the host tier
    on: the key structure of ``request_states`` and ``pool_debug_state``
    equals the JAX engine's, ``live_executables`` included."""
    views = []
    for eng, clock in _engines(tiny_cfg, tiny_params, host_pages=8):
        rng = np.random.default_rng(4)
        for gen in (6, 16, 6, 6):
            eng.submit(rng.integers(0, tiny_cfg.vocab_size - 1, 6), gen)
        seen = {}

        def on_step(e, seen=seen):
            if e.done and e.queue and "states" not in seen:
                seen["states"] = e.request_states()
                seen["pool"] = e.pool_debug_state()
        eng.run(on_step=on_step)
        views.append(seen)
    jv, tv = views
    for name in ("queued", "running", "done"):
        assert tv["states"][name] and jv["states"][name], name
    assert _keys(tv["states"]) == _keys(jv["states"])
    assert jv["pool"]["live_executables"] >= 0
    assert tv["pool"]["live_executables"] == 0      # nothing loaded on CPU
    assert set(tv["pool"]) == {"paged", "pool", "host_pool", "tier",
                               "live_executables"}
    assert _keys(tv["pool"]) == _keys(jv["pool"])
