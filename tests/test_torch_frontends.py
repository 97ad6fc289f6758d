"""PyTorch port vs the JAX package: the stub frontends.

InternVL2-76B (vision: patch embeddings before the text) and HuBERT-XLarge
(audio frames, learned positions, no rope, encoder-only), reduced, on the
same weights: ``embed_inputs`` and the forward agree; the VLM decodes with
per-row patches token-identical to the JAX XLA decode (the text offset
follows the patches); ``replace_rows`` with ``row_extras`` splices a row's
patches as the JAX session does (the JAX ``tests/test_session.py``
contract); and neither engine serves a VLM: both raise ``KeyError
'patches'`` when a request reaches the step, since requests carry no
patches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import strategy_from_spec as jstrategy_from_spec
from repro.dlm.session import DecodeSession as JSession
from repro.models import transformer as jt

from _torch_parity import (assert_caches_close, np32, port_cfg, port_params,
                           port_proxies)
from repro_torch.core.strategy import strategy_from_spec
from repro_torch.dlm.session import DecodeSession as TSession
from repro_torch.kernels.backend import TORCH_BACKEND
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
N_TEXT, GEN = 24, 8


@pytest.fixture(scope="module")
def vlm():
    cfg = reduced(get_arch("internvl2-76b"))
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    patches = (rng.standard_normal((3, cfg.frontend_tokens, cfg.d_model))
               * 0.02).astype(np.float32)
    return cfg, params, patches, rng


def _canvas(cfg, rng, n_text, gen_len):
    p_len = n_text - gen_len
    row = np.full((n_text,), cfg.mask_id, np.int32)
    row[:p_len] = rng.integers(0, cfg.vocab_size - 1, p_len)
    active = np.zeros((n_text,), bool)
    active[p_len:] = True
    return row, active


def _sessions(cfg, params):
    js = JSession(params, cfg)
    tcfg = port_cfg(cfg)
    ts = TSession(port_params(params, tcfg), tcfg,
                  spa_proxies=port_proxies(js.spa_proxies, tcfg),
                  backend=TORCH_BACKEND, device="cpu")
    return js, ts


@pytest.mark.parametrize("arch", ["internvl2-76b", "hubert-xlarge"])
def test_embed_and_forward_match_jax(arch):
    """Patches before the text (vision); frames plus learned positions and
    no rope (audio): h0 and the final hidden states within 1e-5."""
    cfg = reduced(get_arch(arch))
    tcfg = port_cfg(cfg)
    params = jt.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    if cfg.frontend == "vision":
        inputs = {"tokens": rng.integers(0, 500, (2, 12)).astype(np.int32),
                  "patches": rng.standard_normal(
                      (2, cfg.frontend_tokens, cfg.d_model)).astype(
                          np.float32)}
    else:
        inputs = {"frames": rng.standard_normal(
            (2, 20, cfg.d_model)).astype(np.float32)}
    jh0 = jt.embed_inputs(params, cfg, {k: jnp.asarray(v)
                                        for k, v in inputs.items()})
    jh = jt.forward_hidden(params, cfg, jh0)[0]
    tp = port_params(params, tcfg)
    th0 = tt.embed_inputs(tp, tcfg, {k: torch.from_numpy(v)
                                     for k, v in inputs.items()})
    th = tt.forward_hidden(tp, tcfg, th0)[0]
    np.testing.assert_allclose(np32(th0), np.asarray(jh0), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np32(th), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    n = th0.shape[1]
    assert n == (12 + cfg.frontend_tokens if cfg.frontend == "vision"
                 else 20)


def test_vlm_decode_matches_jax(vlm):
    """Per-row patches through ``prefill(extras=)``: identical tokens and
    step counts, caches within 1e-4 (the cache spans patches + text)."""
    cfg, params, patches, _ = vlm
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size - 1, (2, N_TEXT - GEN)).astype(np.int32)
    extras = patches[:2]
    js, ts = _sessions(cfg, params)
    js.prefill(jnp.asarray(prompt), GEN,
               extras={"patches": jnp.asarray(extras)})
    j_toks, j_info = js.run()
    ts.prefill(torch.from_numpy(prompt), GEN,
               extras={"patches": torch.from_numpy(extras)})
    t_toks, t_info = ts.run()
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert t_info["steps"] == j_info["steps"]
    assert_caches_close(jax.tree.map(np.asarray, js.state.cache),
                        ts.state.cache)
    kind = cfg.layer_pattern[0]
    assert ts.state.cache[kind]["k"].shape[2] == cfg.frontend_tokens + N_TEXT
    # the session owns its extras: the caller's dict is not aliased
    given = {"patches": torch.from_numpy(extras.copy())}
    ts.prefill(torch.from_numpy(prompt), GEN, extras=given)
    ts.state.extras["leak"] = torch.zeros(())
    assert "leak" not in given


def test_replace_rows_with_extras_matches_jax(vlm):
    """The JAX ``test_replace_rows_with_extras`` through both sessions:
    row 1 swapped after two steps, with its own patches; both runs decode
    the same tokens, the spliced patches are the new row's, and the
    swapped row decodes as a fresh session on its canvas does."""
    cfg, params, patches, _ = vlm
    rng = np.random.default_rng(5)
    r0, a0 = _canvas(cfg, rng, 16, 4)
    r1a, a1a = _canvas(cfg, rng, 16, 4)
    r1b, a1b = _canvas(cfg, rng, 16, 4)
    p0, p1a, p1b = patches
    js, ts = _sessions(cfg, params)
    for sess, arr in ((js, jnp.asarray), (ts, torch.from_numpy)):
        sess.attach(np.stack([r0, r1a]), active=np.stack([a0, a1a]),
                    extras={"patches": arr(np.stack([p0, p1a]))})
        sess.step()
        sess.step()
        sess.replace_rows([1], r1b[None], a1b[None],
                          row_extras={"patches": p1b[None]})
    np.testing.assert_array_equal(np32(ts.state.extras["patches"][1]), p1b)
    j_toks, _ = js.run()
    t_toks, _ = ts.run()
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    _, ref = _sessions(cfg, params)
    ref.attach(np.stack([r1b, r1b]), active=np.stack([a1b, a1b]),
               extras={"patches": torch.from_numpy(np.stack([p1b, p1b]))})
    ref_toks, _ = ref.run()
    np.testing.assert_array_equal(t_toks[1].numpy(), ref_toks[0].numpy())
    assert int((t_toks == cfg.mask_id).sum()) == 0


def test_neither_engine_serves_a_vlm(vlm):
    """The JAX engine has no per-request patches, so a VLM request fails
    at its first step with ``KeyError: 'patches'``; the port's does the
    same."""
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import ServingEngine as TEngine
    cfg, params, _, _ = vlm
    tcfg = port_cfg(cfg)
    for eng in (JEngine(cfg, params, max_batch=2, canvas_len=16),
                TEngine(tcfg, port_params(params, tcfg), max_batch=2,
                        canvas_len=16, device="cpu")):
        eng.submit(np.arange(1, 6, dtype=np.int32), gen_len=4)
        with pytest.raises(KeyError, match="patches"):
            eng.run()


def test_hubert_has_no_decode_but_trains_its_tree():
    """HuBERT is encoder-only: the port's init draws ``pos_embed`` and the
    plain MLP's biases, no rope is applied, and its strategy spec still
    resolves (the JAX config's ``spa``)."""
    cfg = reduced(get_arch("hubert-xlarge"))
    tcfg = port_cfg(cfg)
    tp = tt.init_params(tcfg, 0, device="cpu")
    assert tp["pos_embed"].shape == (tcfg.max_position, tcfg.d_model)
    assert sorted(tp["blocks"]["attn"]["ffn"]) == ["b_down", "b_up",
                                                   "w_down", "w_up"]
    assert tcfg.is_encoder_only and tcfg.frontend == "audio"
    assert strategy_from_spec(tcfg.spa).name == jstrategy_from_spec(
        cfg.spa).name
