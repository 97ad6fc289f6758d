"""PyTorch port vs the JAX package: Dream-7B and DeepSeek-67B, reduced.

Dream keeps its GQA group of 7 (7 query heads on one kv head of 128), its
rank-32 proxies and its adaptive ρ schedule; DeepSeek its int8 cache and a
GQA group of 8.  Each decodes the same prompt with the same weights and
proxies in both packages (the JAX side on its ``XlaBackend``) under the
config's singular strategy, the value baseline and ``NoCache``: identical
tokens and step counts, float caches within 1e-4, int8 codes within 1.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jt

from _torch_parity import dense_cfg, dense_decode_parity, port_cfg
from repro_torch.core import spa_layer as tspa_layer
from repro_torch.kernels.backend import CUDA_BACKEND

torch.set_num_threads(1)
P_LEN, GEN = 84, 12


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("dream-7b", "deepseek-67b"):
        cfg = dense_cfg(name)
        params = jt.init_params(cfg, jax.random.PRNGKey(0))
        prompt = np.random.default_rng(2).integers(
            0, cfg.vocab_size - 1, (2, P_LEN)).astype(np.int32)
        out[name] = (cfg, params, prompt)
    return out


@pytest.mark.parametrize("name", ["dream-7b", "deepseek-67b"])
@pytest.mark.parametrize("strategy", ["singular", "value", "none"])
def test_dense_decode_matches_jax(models, name, strategy):
    cfg, params, prompt = models[name]
    sess = dense_decode_parity(cfg, params, prompt, GEN, strategy,
                               backend=CUDA_BACKEND)
    if strategy == "none":
        assert not sess.state.cache
        return
    cache = sess.state.cache["attn"]
    if name == "deepseek-67b":
        assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    ks = tspa_layer.layer_ks(port_cfg(cfg), sess.strategy, P_LEN + GEN)
    assert max(ks) < P_LEN + GEN       # the decode ran sparse layer steps
    if strategy == "singular":
        assert cache["proxy"].shape[-1] == cfg.spa.rank


def test_dream_keeps_its_shapes(models):
    """The reduced Dream keeps the full config's group of 7, r = 32 and
    the paper's ρ schedule (ρ_p 0.30, ρ_1 0.05, ρ_L 0.25)."""
    cfg = models["dream-7b"][0]
    assert cfg.n_heads // cfg.n_kv_heads == 7 and cfg.spa.rank == 32
    assert (cfg.spa.rho_peak, cfg.spa.rho_first, cfg.spa.rho_last) == (
        0.30, 0.05, 0.25)
