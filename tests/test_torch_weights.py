"""The weights bridge: JAX parameters (numpy leaves) -> the port's.

``from_numpy_params`` must carry every leaf across with its shape, dtype
(bfloat16 included) and exact values, in the same tree; carried-over
singular proxies must make both packages score identically (f32 1e-6:
one cosine over the same proxy matrix, summed in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import SPACache as JSPACache
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg
from repro_torch import weights
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.kernels.backend import TORCH_BACKEND

torch.set_num_threads(1)


def _eight_layer():
    return reduced(get_arch("internlm2-1.8b"), n_layers=8)


@pytest.fixture(params=["tiny", "eight_layer", "llada_bf16"])
def cfg(request, tiny_cfg):
    if request.param == "tiny":
        return tiny_cfg
    if request.param == "eight_layer":
        return _eight_layer()
    return dataclasses.replace(reduced(get_arch("llada-8b")),
                               param_dtype="bfloat16")


def test_round_trip_every_leaf(cfg):
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tparams = weights.from_numpy_params(tree, port_cfg(cfg), "cpu")
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    n = 0
    for path, a in leaves:
        t = tparams
        for key in path:
            t = t[key.key]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        np.testing.assert_array_equal(np32(t), a.astype(np.float32))
        n += 1
    assert n == len(jax.tree.leaves(tparams))


def test_carried_proxies_give_same_scores():
    cfg = _eight_layer()
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    jstrat = JSPACache(rank=16)
    proxies = jstrat.build_proxies(params, cfg)
    tcfg = port_cfg(cfg)
    tprox = weights.from_numpy_proxies(jax.tree.map(np.asarray, proxies),
                                       tcfg, "cpu")
    tstrat = TSPACache(rank=16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pc = rng.standard_normal((2, 40, 16)).astype(np.float32)
    for layer in (0, 7):
        pm = proxies["attn"][layer]
        p_now = jstrat.project(jnp.asarray(x), {}, pm)
        want = jstrat.score(p_now, jnp.asarray(pc))
        got, t_p = TORCH_BACKEND.identifier_scores(
            tstrat, {}, tprox["attn"][layer], torch.from_numpy(x),
            torch.from_numpy(pc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(t_p.numpy(), np.asarray(p_now),
                                   rtol=1e-5, atol=1e-5)


def test_bridge_rejects_mismatched_config(tiny_cfg):
    params = jax.tree.map(np.asarray,
                          jt.init_params(tiny_cfg, jax.random.PRNGKey(0)))
    other = dataclasses.replace(port_cfg(tiny_cfg), d_model=128)
    with pytest.raises(ValueError):
        weights.from_numpy_params(params, other, "cpu")
