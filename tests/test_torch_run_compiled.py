"""PyTorch port vs the JAX package: ``DecodeSession.run_compiled`` and
``events``.

For every unmask scheduler, with a refresh every 3 steps, the port's
``run_compiled`` gives the tokens, step count and refresh count of the
port's ``run`` and of the JAX ``run_compiled`` (one ``lax.while_loop``);
a second call on the finished session runs 0 steps in both packages.  The
stochastic schedulers replay the JAX decode's draws (``ReplayDraws``, as in
``tests/test_torch_schedulers.py``).  ``events`` yields the JAX
``StepEvent`` stream field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import SPACache as JSPACache
from repro.dlm import scheduler as jsched
from repro.dlm.decoding import DecodeSettings as JSettings
from repro.dlm.session import DecodeSession as JSession
from repro.models import transformer as jt

from _torch_parity import (ReplayDraws, jax_draws, port_cfg, port_params,
                           port_proxies)
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.dlm import scheduler as tsched
from repro_torch.dlm.decoding import DecodeSettings as TSettings
from repro_torch.dlm.session import DecodeSession as TSession

torch.set_num_threads(1)
P_LEN, GEN, REFRESH = 40, 12, 3
SEED = 5
SCHEDULERS = {
    "confidence": {},
    "parallel": dict(threshold=0.0022, max_parallel=3),
    "entropy": dict(threshold=6.236, max_parallel=3),
    "temperature": dict(temperature=0.8),
    "random_order": {},
    "block": dict(block_len=4, threshold=0.0022, max_parallel=2),
}


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=2)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size - 1, (2, P_LEN)).astype(np.int32)
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    jstrat = JSPACache(**spec)
    jprox = jstrat.build_proxies(params, cfg)
    tcfg = port_cfg(cfg)
    return (cfg, params, prompt, jstrat, jprox, tcfg,
            port_params(params, tcfg), TSPACache(**spec),
            port_proxies(jprox, tcfg))


def _sessions(small, name):
    cfg, params, prompt, jstrat, jprox, tcfg, tparams, tstrat, tprox = small
    kw = SCHEDULERS.get(name, {})
    js = JSession(params, cfg, strategy=jstrat, spa_proxies=jprox,
                  scheduler=jsched.SCHEDULERS[name](**kw),
                  settings=JSettings(refresh_interval=REFRESH))
    js.prefill(jnp.asarray(prompt), GEN,
               rng=SEED if js.scheduler.uses_rng else None)

    def port():
        ts = TSession(tparams, tcfg, strategy=tstrat, spa_proxies=tprox,
                      scheduler=tsched.SCHEDULERS[name](**kw),
                      settings=TSettings(refresh_interval=REFRESH),
                      backend="torch", device="cpu")
        rng = None
        if ts.scheduler.uses_rng:
            rng = ReplayDraws(jax_draws(name, SEED, GEN + 4, 2,
                                        min(64, P_LEN + GEN),
                                        cfg.vocab_size))
        ts.prefill(torch.from_numpy(prompt), GEN, rng=rng)
        return ts

    return js, port


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_run_compiled_matches_run_and_jax(small, name):
    js, port = _sessions(small, name)
    j_toks, j_info = js.run_compiled()
    ts = port()
    t_toks, t_info = ts.run_compiled()
    tr = port()
    r_toks, r_info = tr.run()
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(r_toks.numpy(), t_toks.numpy())
    assert t_info == r_info == {"steps": j_info["steps"],
                                "refreshes": j_info["refreshes"]}
    assert t_info["refreshes"] == (t_info["steps"] - 1) // REFRESH > 0
    # a finished session runs no step and no refresh
    finished = {"steps": 0, "refreshes": t_info["refreshes"]}
    assert js.run_compiled()[1] == ts.run_compiled()[1] == finished


@pytest.mark.parametrize("name", ["confidence", "parallel"])
def test_events_match_jax(small, name):
    js, port = _sessions(small, name)
    j_events = list(js.events())
    t_events = list(port().events())
    assert len(t_events) == len(j_events) > REFRESH
    assert any(e.refreshed for e in t_events)
    for te, je in zip(t_events, j_events):
        for f in dataclasses.fields(je):
            got, want = getattr(te, f.name), getattr(je, f.name)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                assert got == want, f.name
    assert t_events[-1].done and not any(e.done for e in t_events[:-1])
