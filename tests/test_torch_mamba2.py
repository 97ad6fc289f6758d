"""PyTorch port vs the JAX package: the attention-free Mamba2 stack.

A reduced Mamba2-370m (SSD blocks only, d_model 128, 16 heads of 16,
d_state 16, chunk 16) of 2 and 4 layers decodes through the port's
``DecodeSession`` (CPU) and the JAX ``DecodeSession`` (XlaBackend) with
the same weights.  Its ``spa.identifier`` is "none", so both resolve to
``NoCache``: every step recomputes every layer in both directions, with no
cache, no proxies and no attention layer.  The bar: identical token
streams and step counts, and the hidden states of the final canvas
within 1e-4 (f32 sums in another order, then 2-4 layers of them).

Also: the port's init has the JAX package's parameter tree, the weights
bridge checks an SSD block's own leaf, the test helper carries
``SSMConfig`` across, and the serving engine refuses the model (serving
a recurrent model is a later slice).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import transformer as jt

from _torch_parity import decode_both, np32, port_cfg, port_params
from repro_torch import weights
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import reduced as treduced
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.strategy import NoCache
from repro_torch.models import transformer as tt

torch.set_num_threads(1)


def _cfg(n_layers):
    return reduced(get_arch("mamba2-370m"), n_layers=n_layers)


def _hidden(cfg, params, tcfg, tparams, tokens):
    """The final hidden states of one canvas in both packages."""
    jh = jt.embed_inputs(params, cfg, {"tokens": jnp.asarray(tokens)})
    jh = jt.forward_hidden(params, cfg, jh)[0]
    th = tt.embed_inputs(tparams, tcfg,
                         {"tokens": torch.from_numpy(np.array(tokens))})
    th = tt.forward_hidden(tparams, tcfg, th)[0]
    return np32(jh), np32(th)


@pytest.mark.parametrize("n_layers", [2, 4])
def test_mamba2_decode_matches_jax(n_layers):
    cfg = _cfg(n_layers)
    params = jt.init_params(cfg, jax.random.PRNGKey(n_layers))
    prompt = np.random.default_rng(n_layers).integers(
        0, cfg.vocab_size - 1, (2, 40))
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, 16, None, None)
    assert isinstance(sess.strategy, NoCache)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == 16
    assert sess.state.cache == {} and sess.spa_proxies is None
    assert not jax.tree.leaves(j_cache)
    jh, th = _hidden(cfg, params, port_cfg(cfg), sess.params, j_toks)
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-4)


def test_mamba2_entry_points_agree(monkeypatch):
    """A model with no attention layer through every decode entry point:
    ``decode``, ``prefill(use_cache=False)`` + ``step`` and the session's
    ``run`` give the same tokens; a cache-less prefill runs no forward."""
    from repro_torch.dlm import decoding
    from repro_torch.dlm.session import DecodeSession
    tcfg = port_cfg(_cfg(2))
    tparams = tt.init_params(tcfg, seed=3, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size - 1, (2, 24)))
    sess = DecodeSession(tparams, tcfg, device="cpu")
    sess.prefill(prompt, 8)
    want, info = sess.run()
    assert info["steps"] == 8 and sess.state.cache == {}
    got, _ = decoding.decode(tparams, tcfg, prompt, 8, device="cpu")
    assert torch.equal(got, want)
    calls = []
    real = tt.forward_hidden

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tt, "forward_hidden", spy)
    sess = DecodeSession(tparams, tcfg, device="cpu")
    sess.prefill(prompt, 8, use_cache=False)
    assert calls == []
    while not sess.done:
        sess.step()
    assert len(calls) == sess.steps_taken == 8
    assert torch.equal(sess.tokens, want)


def test_mamba2_init_matches_jax_tree():
    """The port's random init has the JAX init's leaves and shapes (with
    and without an FFN), in the config's dtype."""
    for d_ff in (0, 64):
        cfg = dataclasses.replace(_cfg(2), d_ff=d_ff)
        jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
            lambda k: jt.init_params(cfg, k), jax.random.PRNGKey(0)))
        tparams = tt.init_params(port_cfg(cfg), seed=0, device="cpu")
        tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
        assert tshapes == jshapes
        assert {t.dtype for t in jax.tree.leaves(tparams)} == {torch.float32}
    full = tget_arch("mamba2-370m")
    assert full.ssm == TSSM(d_state=128, d_conv=4, expand=2, head_dim=64,
                            chunk_size=256)
    assert full.param_count() == get_arch("mamba2-370m").param_count()
    assert treduced(full).ssm == TSSM(d_state=16, d_conv=4, expand=2,
                                      head_dim=16, chunk_size=16)


def test_weights_bridge_checks_the_ssd_leaf():
    cfg = _cfg(2)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = port_cfg(cfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = weights.from_numpy_params(tree, tcfg, "cpu")
    mixer = tparams["blocks"]["ssd"]["mixer"]
    for name, a in tree["blocks"]["ssd"]["mixer"].items():
        np.testing.assert_array_equal(np32(mixer[name]), a)
    # [Lk, d, 2 di + 2 ds + nh] = [2, 128, 2 * 256 + 2 * 16 + 16]
    assert mixer["w_in"].shape == (2, 128, 560)
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["ssd"]["mixer"]["w_in"] = np.zeros((2, 128, 544),
                                                     np.float32)
    with pytest.raises(ValueError, match="mixer.w_in"):
        weights.from_numpy_params(bad, tcfg, "cpu")


def test_port_cfg_carries_ssm():
    cfg = _cfg(2)
    tcfg = port_cfg(cfg)
    assert isinstance(tcfg.ssm, TSSM)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(tget_arch("mamba2-370m")) == \
        dataclasses.asdict(get_arch("mamba2-370m"))


def test_engine_refuses_mamba2():
    from repro_torch.serving.engine import ServingEngine
    cfg = _cfg(2)
    tcfg = port_cfg(cfg)
    tparams = port_params(jt.init_params(cfg, jax.random.PRNGKey(0)), tcfg)
    with pytest.raises(NotImplementedError, match="ssd"):
        ServingEngine(tcfg, tparams, device="cpu")
