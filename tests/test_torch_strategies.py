"""PyTorch port vs the JAX package: the caching baselines and the
incremental identifier, whole decodes through DecodeSession.run.

The strategies of ``tests/test_backend_parity.py`` that the port adds in
this slice (``spa_incremental``, ``value``, ``attn_in``, ``window``,
``attn_out``), plus ``ValueProxyCache`` with the ``query`` and ``key``
projections, decode the same prompt with the same weights in both packages
(the JAX side on its ``XlaBackend``).  The bar is the one the Pallas suite
meets against XLA: IDENTICAL token streams and step counts; float cache
buffers within rtol/atol 1e-4 (f32 sums in another order, ~1e-6 after a
decode; tokens still agree because selection quantizes scores); int8
cache codes within 1.

Regimes as in ``tests/test_torch_decode.py``: 2 layers run the exact
``k_schedule`` for every strategy; 8 layers (homogeneous attention,
``scan_layers``, 3 buckets) run the JAX layer scan's bucketed k for the
incremental identifier, while ``window`` keeps the exact k there because
its locality scores override identification (the JAX scan runs only
without an override).  The 8-layer window case uses an adaptive budget so
the two k rules really differ.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core import strategy as jstrategy
from repro.models import transformer as jt

from _torch_parity import assert_caches_close, decode_both, port_cfg
from repro_torch.core import spa_layer as tspa_layer
from repro_torch.core import strategy as tstrategy
from repro_torch.kernels.backend import CUDA_BACKEND, TORCH_BACKEND

torch.set_num_threads(1)

REGIMES = {"exact_ks_2l": (2, 84, 12, 6), "bucketed_ks_8l": (8, 148, 12, 3)}
_ADAPTIVE = dict(schedule="adaptive", rho=0.3, rho_first=0.05,
                 rho_last=0.15)
# name -> (class name, constructor kwargs); the same in both packages
STRATEGIES = {
    "spa_incremental": ("SPACache", dict(rank=16, incremental_ident=True)),
    "value": ("ValueProxyCache", dict(rho=0.3)),
    "query": ("ValueProxyCache", dict(projection="query", rho=0.3)),
    "key": ("ValueProxyCache", dict(projection="key", rho=0.3)),
    "attn_in": ("ValueProxyCache", dict(projection="attn_in", rho=0.3)),
    "window": ("WindowCache", dict(locality_window=8, **_ADAPTIVE)),
    "attn_out": ("AttnOutCache", dict(rho=0.5)),
}
CASES = [(name, "exact_ks_2l") for name in sorted(STRATEGIES)] + [
    ("window", "bucketed_ks_8l"), ("spa_incremental", "bucketed_ks_8l")]


def _pair(name, nb):
    cls, kw = STRATEGIES[name]
    return (getattr(jstrategy, cls)(n_buckets=nb, **kw),
            getattr(tstrategy, cls)(n_buckets=nb, **kw))


@pytest.fixture(scope="module")
def regimes():
    out = {}
    for name, (n_layers, p_len, gen, nb) in REGIMES.items():
        cfg = reduced(get_arch("internlm2-1.8b"), n_layers=n_layers)
        params = jt.init_params(cfg, jax.random.PRNGKey(0))
        prompt = np.random.default_rng(1).integers(
            0, cfg.vocab_size - 1, (2, p_len)).astype(np.int32)
        out[name] = (cfg, params, prompt, gen, nb)
    return out


@pytest.mark.parametrize("name,regime", CASES)
def test_strategy_decode_matches_jax(regimes, name, regime):
    cfg, params, prompt, gen, nb = regimes[regime]
    jstrat, tstrat = _pair(name, nb)
    j_toks, j_info, j_cache, t_toks, t_info, ts = decode_both(
        cfg, params, prompt, gen, jstrat, tstrat)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == gen
    assert_caches_close(j_cache, ts.state.cache)
    n = prompt.shape[1] + gen
    ks = tspa_layer.layer_ks(port_cfg(cfg), tstrat, n,
                             scores_override=name == "window")
    assert max(ks) < n                 # the decode ran sparse layer steps
    if name == "spa_incremental":
        assert "proxy_now" in ts.state.cache["attn"]


def test_window_keeps_exact_ks_in_the_bucketed_regime(regimes):
    """The 8-layer window case must be one where bucketing would change k
    (else the case above could not tell the two rules apart)."""
    cfg, _, prompt, gen, nb = regimes["bucketed_ks_8l"]
    tcfg = port_cfg(cfg)
    strat = _pair("window", nb)[1]
    n = prompt.shape[1] + gen
    exact = strat.k_schedule(tcfg, n)
    assert tspa_layer.layer_ks(tcfg, strat, n, scores_override=True) == exact
    assert tspa_layer.layer_ks(tcfg, strat, n) != exact


def test_int8_cache_decode_matches_jax(regimes):
    cfg, params, prompt, gen, nb = regimes["exact_ks_2l"]
    cfg8 = dataclasses.replace(cfg, cache_dtype="int8")
    jstrat, tstrat = _pair("value", nb)
    j_toks, j_info, j_cache, t_toks, t_info, ts = decode_both(
        cfg8, params, prompt, gen, jstrat, tstrat)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"]
    assert ts.state.cache["attn"]["k"].dtype == torch.int8
    assert_caches_close(j_cache, ts.state.cache)


def test_cuda_backend_on_cpu_equals_torch_backend(regimes):
    """CudaBackend's wrappers take their plain versions for CPU tensors,
    so every new strategy decodes identically on both backends."""
    from _torch_parity import port_params
    from repro_torch.dlm.session import DecodeSession as TSession
    cfg, params, prompt, gen, nb = regimes["exact_ks_2l"]
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    for name in sorted(STRATEGIES):
        strat = _pair(name, nb)[1]
        outs = []
        for backend in (TORCH_BACKEND, CUDA_BACKEND):
            ts = TSession(tparams, tcfg, strategy=strat, backend=backend,
                          device="cpu")
            ts.prefill(torch.from_numpy(prompt), gen)
            outs.append(ts.run()[0])
        assert torch.equal(outs[0], outs[1]), name


def test_registry_and_specs_match_jax():
    """Every JAX identifier is registered, and a strategy's spec round
    trips to the same strategy (the serializable format of both)."""
    assert sorted(tstrategy.REGISTRY) == sorted(jstrategy.REGISTRY)
    for name, (cls, kw) in STRATEGIES.items():
        t = getattr(tstrategy, cls)(**kw)
        assert tstrategy.strategy_from_spec(t.spec) == t, name
        j = getattr(jstrategy, cls)(**kw)
        assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    jcfg = reduced(get_arch("internlm2-1.8b"), n_layers=2)
    cfg = port_cfg(jcfg)
    for ident in ("value", "query", "key", "attn_in", "window",
                  "attn_out"):
        t = tstrategy.strategy_from_spec(
            dataclasses.replace(cfg.spa, identifier=ident))
        j = jstrategy.strategy_from_spec(
            dataclasses.replace(jcfg.spa, identifier=ident))
        assert type(t).__name__ == type(j).__name__
        assert t.spec.identifier == ident
        assert t.proxy_dim(cfg) == j.proxy_dim(jcfg), ident
