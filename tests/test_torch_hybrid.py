"""PyTorch port vs the JAX package: the RG-LRU hybrid (RecurrentGemma).

A reduced RecurrentGemma of 6 layers ((rglru, rglru, local) twice) decodes
a short canvas (64 rows: no stratification, the dense attention grid)
through the JAX ``DecodeSession.run`` (XlaBackend) and the port's, with
the same weights and proxies, under ``singular``, the incremental
identifier and ``attn_out``.  The bar: identical token streams and step
counts, cache buffers within rtol/atol 1e-4 (f32 sums in another order,
and the port's sequential recurrence against the JAX associative scan).
The long canvas (N = 12288: stratified selection and the banded grid)
runs in ``test_torch_hybrid_long*.py``, one identifier a file.

Also the repairs a hybrid needs: the weights bridge checks each layer
kind's own leaves, the test helper carries ``RGLRUConfig`` (and
``SSMConfig``) across and still refuses MoE configs, the incremental
identifier identifies in full after a recurrent block, and the serving
engine serves a hybrid and an SSD stack (MoE still refuses).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import transformer as jt

from _torch_parity import (assert_caches_close, decode_both, hybrid_cfg,
                           hybrid_strategies, np32, port_cfg, port_params)
from repro_torch import weights
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.base import RGLRUConfig as TRGLRU
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.models import transformer as tt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hybrid():
    cfg = hybrid_cfg()
    return cfg, jt.init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", ["singular", "incremental", "attn_out"])
def test_hybrid_decode_matches_jax(hybrid, name):
    cfg, params = hybrid
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size - 1,
                                               (2, 48))
    jstrat, tstrat = hybrid_strategies(cfg, name)
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, 16, jstrat, tstrat)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == 16
    assert sorted(sess.state.cache) == ["local"]   # attention layers only
    assert_caches_close(j_cache, sess.state.cache)


def test_hybrid_refresh_matches_jax(hybrid):
    """A periodic cache rebuild (every 5 steps) re-runs the hybrid's
    prefill through the strategy, in both packages."""
    from repro.dlm.decoding import DecodeSettings as JSettings
    from repro_torch.dlm.decoding import DecodeSettings as TSettings
    cfg, params = hybrid
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size - 1,
                                               (2, 48))
    jstrat, tstrat = hybrid_strategies(cfg, "singular")
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, 16, jstrat, tstrat,
        settings=JSettings(refresh_interval=5),
        tsettings=TSettings(refresh_interval=5))
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == 16
    assert sess.refresh_count == 3
    assert_caches_close(j_cache, sess.state.cache)


def test_hybrid_prefill_matches_jax(hybrid):
    cfg, params = hybrid
    tcfg = port_cfg(cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    want, _, _ = jt.forward_hidden(params, cfg, jt.embed_inputs(
        params, cfg, {"tokens": jax.numpy.asarray(tokens)}))
    tparams = port_params(params, tcfg)
    _, tstrat = hybrid_strategies(cfg, "singular")
    got, _, caches = tt.forward_hidden(tparams, tcfg, tt.embed_inputs(
        tparams, tcfg, {"tokens": torch.from_numpy(tokens)}),
        collect_cache=True, strategy=tstrat,
        spa_proxies=tstrat.build_proxies(tparams, tcfg))
    # six layers of f32 sums in another order (the recurrence too): 1e-4,
    # the decode's cache tolerance
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-4, atol=1e-4)
    assert sorted(caches) == ["local"] and caches["local"]["k"].shape[0] == 2


def test_weights_check_each_kinds_own_leaves(hybrid):
    """Fault 2: the bridge checked ``wq`` on every kind (KeyError on an
    RG-LRU block); now ``wq`` on attention kinds, ``mixer.w_in`` on
    rglru, and a wrong shape of either still raises."""
    cfg, params = hybrid
    tcfg = port_cfg(cfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = weights.from_numpy_params(tree, tcfg, "cpu")
    mixer = tparams["blocks"]["rglru"]["mixer"]
    assert sorted(mixer) == sorted(tree["blocks"]["rglru"]["mixer"])
    for name, a in tree["blocks"]["rglru"]["mixer"].items():
        np.testing.assert_array_equal(np32(mixer[name]), a)
    assert mixer["w_a"].shape == (4, 4, 32, 32)        # [Lk, nb, c, c]
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["rglru"]["mixer"]["w_in"] = np.zeros((4, 128, 64),
                                                       np.float32)
    with pytest.raises(ValueError, match="mixer.w_in"):
        weights.from_numpy_params(bad, tcfg, "cpu")


def test_port_cfg_carries_rglru_and_refuses_moe_and_ssm(hybrid):
    """Fault 3: the helper refused any config with ``rglru``.  It carries
    ``SSMConfig`` too since the SSD mixer is ported, and ``MoEConfig``
    since the MoE FFN is (it refused MoE before)."""
    cfg, _ = hybrid
    tcfg = port_cfg(cfg)
    assert isinstance(tcfg.rglru, TRGLRU)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    mamba = reduced(get_arch("mamba2-370m"))
    assert isinstance(port_cfg(mamba).ssm, TSSM)
    assert dataclasses.asdict(port_cfg(mamba)) == dataclasses.asdict(mamba)
    mixtral = reduced(get_arch("mixtral-8x22b"))
    assert isinstance(port_cfg(mixtral).moe, TMoE)
    assert dataclasses.asdict(port_cfg(mixtral)) == \
        dataclasses.asdict(mixtral)
    assert dataclasses.asdict(tget_arch("recurrentgemma-9b")) == \
        dataclasses.asdict(get_arch("recurrentgemma-9b"))


def test_incremental_identifies_in_full_after_a_recurrent_block(
        hybrid, monkeypatch):
    """Fault 1: after a recurrent block every input row changed, so the
    next attention layer must identify in full, not re-project only the
    previous attention layer's selection."""
    from repro_torch.core import spa_layer
    from repro_torch.dlm.session import DecodeSession
    cfg, params = hybrid
    tcfg = port_cfg(cfg)
    _, tstrat = hybrid_strategies(cfg, "incremental")
    sess = DecodeSession(port_params(params, tcfg), tcfg, strategy=tstrat,
                         device="cpu")
    sess.prefill(torch.randint(0, 500, (2, 48)), 16)
    seen = []
    real = spa_layer.spa_attn_block

    def spy(*args, **kw):
        seen.append(kw.get("prev_idx"))
        return real(*args, **kw)

    monkeypatch.setattr(spa_layer, "spa_attn_block", spy)
    sess.step()
    assert seen == [None, None]   # layers 2 and 5 follow rglru blocks


def test_engine_refuses_a_hybrid(hybrid):
    """The engine used to refuse recurrent stacks; it serves them now, in
    dense and paged lanes (parity with the JAX engine:
    ``test_torch_recurrent_lanes*.py``).  MoE refused too; now its
    attention blocks draw ``moe`` leaves in place of the FFN, while the
    RG-LRU blocks keep theirs."""
    from repro_torch.serving.engine import ServingEngine
    cfg, params = hybrid
    tcfg = port_cfg(cfg)
    ssd_cfg = dataclasses.replace(tcfg, layer_pattern=("ssd",))
    prompt = np.arange(1, 9, dtype=np.int32)
    for c, p in ((tcfg, port_params(params, tcfg)),
                 (ssd_cfg, tt.init_params(ssd_cfg, device="cpu"))):
        for pool in (0, 9):
            eng = ServingEngine(c, p, max_batch=2, canvas_len=16,
                                pool_pages=pool, page_size=4, device="cpu")
            eng.submit(prompt, gen_len=8)
            eng.run()
            (req,) = eng.done
            assert req.output.shape == (8,)
            assert (req.output != c.mask_id).all()
    moe_cfg = dataclasses.replace(
        tcfg, moe=TMoE(n_experts=4, top_k=2, d_ff_expert=64))
    blocks = tt.init_params(moe_cfg, device="cpu")["blocks"]
    lk, d = moe_cfg.n_layers_of_kind("local"), moe_cfg.d_model
    assert "ffn" not in blocks["local"] and "ffn" in blocks["rglru"]
    assert {k: tuple(v.shape) for k, v in blocks["local"]["moe"].items()} \
        == {"router": (lk, d, 4), "w_gate": (lk, 4, d, 64),
            "w_up": (lk, 4, d, 64), "w_down": (lk, 4, 64, d)}


def test_strata_and_span_bound_match_jax():
    """The stratification rule and the q-span bound that decide between
    the dense and the banded grid (RecurrentGemma-9B's ks at N = 16384:
    720, 1168 and 1744 stay dense, 2416 and up band)."""
    from repro.core import spa_layer as jspa
    from repro_torch.core import spa_layer as tspa
    from repro_torch.kernels.sparse_attention import banded_engages
    for n in (4096, 8192, 8193, 16384, 24576, 100_000):
        for k in (1, 100, 720, 1168, 1744, 2416, 4096, 9000):
            nb = tspa.stratify_blocks_for(n, k)
            assert nb == jspa.stratify_blocks_for(n, k)
            assert tspa.q_span_bound(n, k, nb) == jspa.q_span_bound(n, k, nb)
    spans = {k: tspa.q_span_bound(16384, k, 4)
             for k in (720, 1168, 1744, 2416, 4096)}
    assert [banded_engages(16384, 2048, True, s) for s in spans.values()] \
        == [False, False, False, True, True]
