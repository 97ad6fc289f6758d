"""PyTorch port vs the JAX package: Gemma2-2B and H2O-Danube3-4B, reduced.

Gemma2 keeps head_dim 256 at a GQA group of 2, its alternating local and
global layers, both softcaps, post-norms, the embedding scale and tied
embeddings; Danube3 keeps head_dim 120 at a group of 4 and its sliding
window.  Windows are cut to 64 on a canvas of 192, so the masks bite.
Each decodes the same prompt with the same weights and proxies in both
packages under the config's singular strategy, the value baseline and
``NoCache``: identical tokens and step counts, caches within 1e-4.  A
paged ``ServingEngine`` lane of Gemma2 (one arena per layer kind) serves
the same requests as the JAX engine.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jt

from _torch_parity import (assert_engines_match, dense_cfg,
                           dense_decode_parity, dense_strategies, serve_both)
from repro_torch.kernels.backend import CUDA_BACKEND

torch.set_num_threads(1)
P_LEN, GEN = 176, 16          # canvas 192, windows of 64


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("gemma2-2b", "h2o-danube-3-4b"):
        cfg = dense_cfg(name)
        params = jt.init_params(cfg, jax.random.PRNGKey(0))
        prompt = np.random.default_rng(4).integers(
            0, cfg.vocab_size - 1, (2, P_LEN)).astype(np.int32)
        out[name] = (cfg, params, prompt)
    return out


@pytest.mark.parametrize("name", ["gemma2-2b", "h2o-danube-3-4b"])
@pytest.mark.parametrize("strategy", ["singular", "value", "none"])
def test_windowed_decode_matches_jax(models, name, strategy):
    cfg, params, prompt = models[name]
    assert cfg.window < P_LEN + GEN     # the window masks keys
    sess = dense_decode_parity(cfg, params, prompt, GEN, strategy,
                               backend=CUDA_BACKEND)
    if strategy == "none":
        return
    kinds = sorted(sess.state.cache)
    assert kinds == (["global", "local"] if name == "gemma2-2b"
                     else ["swa"])


def test_gemma2_keeps_its_layer_pattern(models):
    cfg = models["gemma2-2b"][0]
    assert cfg.layer_kinds == ("local", "global")
    assert (cfg.attn_softcap, cfg.logit_softcap) == (50.0, 30.0)
    assert cfg.post_norms and cfg.embed_scale and cfg.tie_embeddings
    assert cfg.head_dim == 256 and cfg.n_heads // cfg.n_kv_heads == 2


def test_gemma2_paged_engine_matches_jax(models):
    """Gemma2 through the paged engine (two arenas, one a layer kind),
    prefix index on: six requests of mixed lengths, one prompt repeated
    (a full hit), on a pool that preempts nothing; outputs and every
    counter as in the JAX engine."""
    cfg, params, _ = models["gemma2-2b"]
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab_size - 1, 20).astype(np.int32)
    reqs = [(shared, 8, 0)] + [
        (rng.integers(0, cfg.vocab_size - 1, int(p)).astype(np.int32),
         int(g), 0) for p, g in ((12, 6), (26, 4), (6, 10), (17, 8))] + [
        (shared, 8, 0)]
    jeng, teng = serve_both(cfg, params, reqs,
                            strategies=dense_strategies(cfg, "singular"),
                            max_batch=2, canvas_len=32, pool_pages=1 + 4 * 8,
                            page_size=4, prefix_cache=True)
    assert_engines_match(jeng, teng)
    arenas = teng.pool.arenas_for(teng.strategy)
    assert sorted(arenas) == ["global", "local"]
    assert teng.stats.prefix_full_hits >= 1
