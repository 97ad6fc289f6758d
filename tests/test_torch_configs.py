"""PyTorch port vs the JAX package: the configurations and their weights.

Every configuration the port registers has the JAX configuration's field
values (nested ``spa`` / ``rglru`` / ``ssm`` included), and
``weights.from_numpy_params`` carries each reduced JAX parameter tree
across leaf for leaf: untied heads, Gemma2's tied embeddings and
post-norms, the hybrid's and Mamba2's mixers.  A tree whose head or
post-norms do not match its config is refused.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.models import transformer as tt

torch.set_num_threads(1)
PORTED = sorted(tconfigs.ARCHS)


def test_port_registers_the_dense_configs():
    """The dense configs, and since the MoE FFN and the stub frontends are
    ported, every configuration of the JAX registry (InternVL2-76B was
    refused before)."""
    from repro.configs import ARCHS
    assert {"dream-7b", "gemma2-2b", "h2o-danube-3-4b",
            "deepseek-67b"} <= set(PORTED)
    assert set(PORTED) == set(ARCHS)
    assert tconfigs.get_arch("internvl2-76b").frontend == "vision"
    with pytest.raises(KeyError):
        tconfigs.get_arch("llama-unknown")


@pytest.mark.parametrize("name", PORTED)
def test_config_fields_match_jax(name):
    tcfg, jcfg = tconfigs.get_arch(name), get_arch(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.source == jcfg.source
    assert tcfg.param_count() == jcfg.param_count()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", PORTED)
def test_jax_tree_carries_across(name):
    """Leaf for leaf, same names, shapes and values; the port's own init
    builds the same tree shape."""
    cfg = reduced(get_arch(name))
    tcfg = port_cfg(cfg)
    params = jax.tree.map(np.asarray,
                          jt.init_params(cfg, jax.random.PRNGKey(1)))
    got = _leaves(weights.from_numpy_params(params, tcfg, "cpu"))
    want = _leaves(params)
    assert sorted(got) == sorted(want)
    for leaf, a in want.items():
        np.testing.assert_array_equal(np32(got[leaf]), np32(a),
                                      err_msg=leaf)
    init = _leaves(tt.init_params(tcfg, 0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in got.items()}
    if name == "gemma2-2b":
        assert "lm_head" not in got
        assert {"blocks.local.norm_post_attn", "blocks.global.norm_post_ffn"
                } <= set(got)


def test_mismatched_trees_are_refused():
    cfg = reduced(get_arch("gemma2-2b"))
    tcfg = port_cfg(cfg)
    params = jax.tree.map(np.asarray,
                          jt.init_params(cfg, jax.random.PRNGKey(1)))
    with_head = dict(params, lm_head=params["embed"].T.copy())
    with pytest.raises(ValueError, match="lm_head"):
        weights.from_numpy_params(with_head, tcfg, "cpu")
    blocks = {k: {n: v for n, v in bp.items() if n != "norm_post_attn"}
              for k, bp in params["blocks"].items()}
    with pytest.raises(ValueError, match="post-norms"):
        weights.from_numpy_params(dict(params, blocks=blocks), tcfg, "cpu")
    dream = reduced(get_arch("dream-7b"))
    dparams = jax.tree.map(np.asarray,
                           jt.init_params(dream, jax.random.PRNGKey(1)))
    dparams.pop("lm_head")
    with pytest.raises(ValueError, match="lm_head"):
        weights.from_numpy_params(dparams, port_cfg(dream), "cpu")
