"""PyTorch port vs the JAX package: every unmask scheduler.

Each registered scheduler decodes the same prompt with the same weights
and singular proxies in both packages (2 layers, ``SPACache``, the JAX
side on ``XlaBackend``).  Token streams and step counts must be
IDENTICAL, and caches within rtol/atol 1e-4, the bar of
``tests/test_torch_decode.py``.

The deterministic schedulers run free.  Their thresholds sit inside the
random model's confidence and entropy ranges (a 512-token vocabulary
keeps confidences near 1/512 and entropies near ln 512), so that parallel
commits really happen; the test checks that they do.  The stochastic
schedulers (``temperature``, ``random_order``) take the very Gumbel and
uniform draws the JAX decode made at each step, recomputed here from its
key chain and fed to the port through a ``Draws`` source that replays
them (the two frameworks' generators give different numbers from one
seed).

Also: the registry and the settings bridge, the port's own seeded
generator (replay from a seed), and the ``decode_semi_ar`` wrapper
(``run_blocks``) against JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import SPACache as JSPACache
from repro.dlm import decoding as jdecoding
from repro.dlm import scheduler as jsched
from repro.models import transformer as jt

from _torch_parity import (assert_caches_close, decode_both, port_cfg,
                           port_params, port_proxies)
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.dlm import decoding as tdecoding
from repro_torch.dlm import scheduler as tsched
from repro_torch.dlm.decoding import DecodeSettings as TSettings
from repro_torch.dlm.session import DecodeSession as TSession

torch.set_num_threads(1)
P_LEN, GEN = 84, 12
SEED = 5
# name -> constructor kwargs, the same in both packages
SCHEDULERS = {
    "confidence": {},
    "parallel": dict(threshold=0.0022, max_parallel=3),
    "entropy": dict(threshold=6.236, max_parallel=3),
    "temperature": dict(temperature=0.8),
    "random_order": {},
    "block": dict(block_len=4, threshold=0.0022, max_parallel=2),
}
PARALLEL = ("parallel", "entropy", "block")


@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=2)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size - 1, (2, P_LEN)).astype(np.int32)
    return cfg, params, prompt


def _strategies():
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    return JSPACache(**spec), TSPACache(**spec)


def _pair(name):
    kw = SCHEDULERS[name]
    return (jsched.SCHEDULERS[name](**kw), tsched.SCHEDULERS[name](**kw))


class ReplayDraws(tsched.Draws):
    """Recorded draws handed out in order, whatever their kind; a draw
    whose shape differs from the request raises."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def _next(self, shape, device):
        out = torch.tensor(self.draws[self.used], dtype=torch.float32,
                           device=device)
        self.used += 1
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out

    uniform = gumbel = _next


def jax_draws(name, seed, steps, b, c, v):
    """The draws the JAX decode makes from PRNGKey(seed): per step the
    state's key splits into (next, step); temperature splits the step key
    into (k_pos, k_tok) and draws Gumbel noise for the tokens [B, C, V]
    and the positions [B, C]; random_order draws a uniform [B, C] from
    the step key.  In the order the port's schedulers ask for them."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, step = jax.random.split(key)
        if name == "temperature":
            k_pos, k_tok = jax.random.split(step)
            out.append(np.asarray(jax.random.gumbel(k_tok, (b, c, v),
                                                    jnp.float32)))
            out.append(np.asarray(jax.random.gumbel(k_pos, (b, c),
                                                    jnp.float32)))
        else:
            out.append(np.asarray(jax.random.uniform(step, (b, c))))
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decode_matches_jax(small, name):
    cfg, params, prompt = small
    js, ts = _pair(name)
    trng = None
    if ts.uses_rng:
        c = min(64, P_LEN + GEN)          # DecodeSettings().n_candidates
        trng = ReplayDraws(jax_draws(name, SEED, GEN + 4, 2, c,
                                     cfg.vocab_size))
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, GEN, *_strategies(), jsched=js, tsched=ts,
        jrng=SEED if ts.uses_rng else None, trng=trng)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"]
    assert_caches_close(j_cache, sess.state.cache)
    if name in PARALLEL:       # more than one commit on some step
        assert t_info["steps"] < GEN, name
    if ts.uses_rng:            # one step's draws per step taken
        per_step = 2 if name == "temperature" else 1
        assert trng.used == per_step * t_info["steps"]


def test_registry_and_settings_bridge():
    assert sorted(tsched.SCHEDULERS) == sorted(jsched.SCHEDULERS)
    for name, cls in tsched.SCHEDULERS.items():
        assert cls.name == name
        assert cls.uses_rng == jsched.SCHEDULERS[name].uses_rng
        inst = tsched.scheduler_from_name(name, **SCHEDULERS[name])
        hash(inst)                      # lane keys need hashability
        assert tsched.scheduler_from_name(name) == cls()
    assert tsched.resolve_scheduler(TSettings()) == \
        tsched.ConfidenceScheduler()
    assert tsched.resolve_scheduler(
        TSettings(parallel_threshold=0.1, max_parallel=2)) == \
        tsched.ParallelThresholdScheduler(threshold=0.1, max_parallel=2)
    assert tsched.resolve_scheduler(
        TSettings(parallel_threshold=0.1),
        tsched.RandomOrderScheduler()) == tsched.RandomOrderScheduler()
    with pytest.raises(ValueError):
        tsched.scheduler_from_name("nope")


def test_settings_path_matches_jax(small):
    """The legacy parallel knobs of DecodeSettings decode as in JAX."""
    from repro.dlm.decoding import DecodeSettings as JSettings
    cfg, params, prompt = small
    kw = dict(parallel_threshold=0.0022, max_parallel=3)
    j_toks, j_info, _, t_toks, t_info, _ = decode_both(
        cfg, params, prompt, GEN, *_strategies(), settings=JSettings(**kw),
        tsettings=TSettings(**kw))
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] < GEN


def test_stochastic_replay_from_seed(small):
    """The port's own generator: the same seed replays the same decode, an
    int seed and a generator seeded alike agree, and a stochastic
    scheduler without rng= gets seed 0."""
    cfg, params, prompt = small
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    strat = _strategies()[1]
    proxies = strat.build_proxies(tparams, tcfg)

    def run(sched, rng):
        sess = TSession(tparams, tcfg, strategy=strat, scheduler=sched,
                        spa_proxies=proxies, device="cpu")
        sess.prefill(torch.from_numpy(prompt), GEN, rng=rng)
        return sess.run()[0]

    for name in ("temperature", "random_order"):
        sched = _pair(name)[1]
        a = run(sched, 3)
        assert torch.equal(a, run(sched, torch.Generator().manual_seed(3)))
        assert torch.equal(run(sched, None), run(sched, 0))
    with pytest.raises(TypeError):
        run(_pair("temperature")[1], "seed")


def test_decode_semi_ar_matches_jax(small):
    """``decode_semi_ar`` (blocks through the active mask, a refresh at
    each block boundary) and ``decode`` give the JAX tokens and steps."""
    cfg, params, prompt = small
    jstrat, tstrat = _strategies()
    proxies = jstrat.build_proxies(params, cfg)
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    tprox = port_proxies(proxies, tcfg)
    j_toks, j_info = jdecoding.decode_semi_ar(
        params, cfg, jnp.asarray(prompt), GEN, block_len=4,
        spa_proxies=proxies, strategy=jstrat)
    t_toks, t_info = tdecoding.decode_semi_ar(
        tparams, tcfg, torch.from_numpy(prompt), GEN, block_len=4,
        spa_proxies=tprox, strategy=tstrat, device="cpu")
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert t_info == j_info and t_info["refreshes"] == GEN // 4 - 1
    t_toks2, t_info2 = tdecoding.decode(
        tparams, tcfg, torch.from_numpy(prompt), GEN, spa_proxies=tprox,
        strategy=tstrat, device="cpu")
    assert t_info2["steps"] == GEN
    assert not (t_toks2[:, P_LEN:] == cfg.mask_id).any()
    state = tdecoding.init_decode_state(
        tcfg, tparams, torch.from_numpy(prompt), GEN, spa_proxies=tprox,
        strategy=tstrat, device="cpu")
    assert int(state.n_masked.sum()) == 2 * GEN and state.rng is None
    assert state.tokens.shape == (2, P_LEN + GEN)
