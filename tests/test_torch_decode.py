"""PyTorch port vs the JAX package: whole decodes through DecodeSession.run.

Both packages decode the same prompt with the same weights and the same
singular proxies (carried across as numpy).  The bar is the one
``tests/test_backend_parity.py`` sets for Pallas against XLA: IDENTICAL
token streams and step counts; float cache buffers within rtol/atol 1e-4
(f32 sums in a different order, ~1e-6 after a decode; tokens still agree
because selection quantizes scores and commits take an argmax); int8
cache codes within 1.

Two regimes, because the JAX package picks k per layer differently:
2 layers run the exact ``k_schedule``; 8 layers (homogeneous attention,
``scan_layers``) run the bucketed k of ``budget.bucketize``, here with 3
buckets so the buckets really merge layers of different k.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import NoCache as JNoCache
from repro.core.strategy import SPACache as JSPACache
from repro.models import transformer as jt

from _torch_parity import (assert_caches_close, decode_both, port_cfg,
                           port_params)
from repro_torch.core import spa_layer as tspa_layer
from repro_torch.core.strategy import NoCache as TNoCache
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.dlm.session import DecodeSession as TSession
from repro_torch.kernels.backend import CUDA_BACKEND, TORCH_BACKEND

torch.set_num_threads(1)

# (n_layers, prompt, gen, n_buckets): canvases long enough that k < N.
REGIMES = {"exact_ks_2l": (2, 84, 12, 6), "bucketed_ks_8l": (8, 148, 12, 3)}
STRATEGIES = {
    "spa_uniform": lambda nb: (
        JSPACache(rank=16, schedule="uniform", rho_peak=0.3, n_buckets=nb),
        TSPACache(rank=16, schedule="uniform", rho_peak=0.3, n_buckets=nb)),
    "spa_adaptive": lambda nb: (JSPACache(rank=16, n_buckets=nb),
                                TSPACache(rank=16, n_buckets=nb)),
    "none": lambda nb: (JNoCache(), TNoCache()),
}


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


def _decode_both(cfg, params, prompt, gen, jstrat, tstrat,
                 backend=TORCH_BACKEND):
    return decode_both(cfg, params, prompt, gen, jstrat, tstrat,
                       backend=backend)


_assert_caches_close = assert_caches_close


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_decode_matches_jax(regimes, regime, strategy):
    cfg, params, prompt, gen, nb = regimes[regime]
    jstrat, tstrat = STRATEGIES[strategy](nb)
    j_toks, j_info, j_cache, t_toks, t_info, ts = _decode_both(
        cfg, params, prompt, gen, jstrat, tstrat)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == gen
    _assert_caches_close(j_cache, ts.state.cache)
    if strategy != "none":     # the decode really ran sparse layer steps
        ks = tspa_layer.layer_ks(port_cfg(cfg), tstrat, prompt.shape[1] + gen)
        assert max(ks) < prompt.shape[1] + gen


def test_bucketed_regime_runs_other_ks_than_exact(regimes):
    """The 8-layer regime must exercise bucketing (else the test above
    could not tell bucketed from exact k)."""
    cfg, _, prompt, gen, nb = regimes["bucketed_ks_8l"]
    tcfg = port_cfg(cfg)
    strat = TSPACache(rank=16, n_buckets=nb)
    n = prompt.shape[1] + gen
    assert tspa_layer.layer_ks(tcfg, strat, n) != strat.k_schedule(tcfg, n)


def test_int8_cache_decode_matches_jax(regimes):
    cfg, params, prompt, gen, nb = regimes["exact_ks_2l"]
    cfg8 = dataclasses.replace(cfg, cache_dtype="int8")
    jstrat, tstrat = STRATEGIES["spa_adaptive"](nb)
    j_toks, j_info, j_cache, t_toks, t_info, ts = _decode_both(
        cfg8, params, prompt, gen, jstrat, tstrat)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"]
    assert ts.state.cache["attn"]["k"].dtype == torch.int8
    _assert_caches_close(j_cache, ts.state.cache)


def test_cuda_backend_on_cpu_equals_torch_backend(regimes):
    """CudaBackend's wrappers take the plain versions for CPU tensors, so
    a CPU decode is identical on both backends."""
    cfg, params, prompt, gen, nb = regimes["exact_ks_2l"]
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    strat = TSPACache(rank=16, n_buckets=nb)
    proxies = strat.build_proxies(tparams, tcfg)
    outs = []
    for backend in (TORCH_BACKEND, CUDA_BACKEND):
        ts = TSession(tparams, tcfg, strategy=strat, spa_proxies=proxies,
                      backend=backend, device="cpu")
        ts.prefill(torch.from_numpy(prompt), gen)
        outs.append(ts.run()[0])
    assert torch.equal(outs[0], outs[1])
