"""PyTorch port vs the JAX package: the MoE FFN (``models/moe.py``).

``apply_moe`` against the JAX function in f32 on the same weights and
inputs: out and the Switch aux loss within 1e-5, with ample capacity, with
overflow (the JAX sentinel overwrite of slot ``cap - 1`` reproduced: with
E=2, top-1, capacity factor 0.25 and T=32, cap=4, experts 0 and 1 keep
tokens [0, 1, 2] and [3, 7, 8], and tokens 4 and 12 give zero rows although
they ranked 4th) and with shared experts; the JAX ``tests/test_mixers.py``
conservation and capacity checks through the port; a combine whose sums
do not depend on the order of its adds; then reduced Mixtral-8x22B (f32
cache) and Qwen3-MoE (int8 cache) decoding token-identical to the JAX XLA
decode under singular + confidence, caches within 1e-4 / int8 codes
within 1 (the engine lanes: ``test_torch_moe_engine.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig
from repro.models import moe as jmoe

from _torch_parity import MOE_CFGS, dense_decode_parity, moe_model, port_cfg
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

CASES = {
    "overflow": (MoEConfig(n_experts=2, top_k=1, d_ff_expert=8,
                           capacity_factor=0.25), 1, 32, 8),
    "ample": (MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=10.0), 2, 16, 8),
    "top3_overflow": (MoEConfig(n_experts=8, top_k=3, d_ff_expert=16,
                                capacity_factor=0.5), 3, 40, 16),
    "shared": (MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                         n_shared_experts=2, d_ff_shared=8), 2, 24, 16),
}


def _tmoe(cfg):
    return TMoE(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _run(name):
    """(JAX out, JAX aux, port out, port aux, port params, x) of a case
    (computed once per case)."""
    cfg, b, t, d = CASES[name]
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), d, cfg, "silu",
                                  jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (b, t, d))
    jo, ja = jax.jit(jmoe.apply_moe, static_argnums=(2, 3))(
        params, x, cfg, "silu")
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    tx = torch.from_numpy(np.array(x))
    to, ta = tmoe.apply_moe(tp, tx, _tmoe(cfg), "silu")
    return np.asarray(jo), float(ja), to.numpy(), float(ta), tp, tx


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_moe_matches_jax(name):
    jo, ja, to, ta, _, _ = _run(name)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    assert abs(ta - ja) <= 1e-5
    # the same rows are zero (dropped to capacity) in both
    np.testing.assert_array_equal(np.linalg.norm(to, axis=-1) == 0,
                                  np.linalg.norm(jo, axis=-1) == 0)


def test_overflow_drops_the_last_slot_as_jax_does():
    """cap = 4 for T = 32: slot 3 of each overflowing expert reads the
    sentinel, so only 3 tokens each keep an output; tokens 4 and 12 (each
    its expert's 4th) are dropped; ``count_drops`` sees 26 of 32."""
    jo, _, to, _, tp, tx = _run("overflow")
    kept = np.flatnonzero(np.linalg.norm(to[0], axis=-1) > 0)
    np.testing.assert_array_equal(kept, [0, 1, 2, 3, 7, 8])
    np.testing.assert_array_equal(
        kept, np.flatnonzero(np.linalg.norm(jo[0], axis=-1) > 0))
    cfg = _tmoe(CASES["overflow"][0])
    assert tmoe._capacity(32, cfg) == 4
    with tmoe.count_drops() as drops:
        tmoe.apply_moe(tp, tx, cfg, "silu")
    assert [int(d) for d in drops] == [26]


def test_moe_conservation_and_capacity():
    """The JAX ``test_mixers.py`` check through the port: with ample
    capacity every token is routed, and the output equals the dense mixture
    of its top-2 experts with renormalised gates; aux >= 1."""
    cfg, b, t, d = CASES["ample"]
    _, _, out, aux, p, x = _run("ample")
    assert np.isfinite(aux) and aux >= 1.0
    probs = torch.softmax(x @ p["router"], dim=-1)
    gv, gi = torch.topk(probs, 2)
    gv = gv / gv.sum(-1, keepdim=True)

    def expert(e, xx):
        gate = torch.nn.functional.silu(xx @ p["w_gate"][e])
        return (gate * (xx @ p["w_up"][e])) @ p["w_down"][e]

    manual = np.zeros_like(out)
    for bi in range(b):
        for ti in range(t):
            manual[bi, ti] = sum(float(gv[bi, ti, j]) * expert(
                int(gi[bi, ti, j]), x[bi, ti]).numpy() for j in range(2))
    np.testing.assert_allclose(out, manual, rtol=2e-3, atol=2e-3)


def test_moe_capacity_drops_overflow():
    """The JAX ``test_mixers.py`` check: a tiny capacity leaves zero rows."""
    _, _, out, _, _, _ = _run("overflow")
    assert (np.linalg.norm(out[0], axis=-1) < 1e-6).sum() > 0


def test_combine_adds_in_expert_order_and_repeats_bitwise():
    """Each token's contributions are summed in the order of its experts'
    indices, whatever the order of the combine's adds: the output equals a
    sequential sum in that order bit for bit, and two calls agree bit for
    bit (top-3 with overflow)."""
    cfg, b, t, d = CASES["top3_overflow"]
    _, _, out, _, p, x = _run("top3_overflow")
    tcfg = _tmoe(cfg)
    again, _ = tmoe.apply_moe(p, x, tcfg, "silu")
    assert torch.equal(again, torch.from_numpy(out))
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    cap = tmoe._capacity(t, tcfg)
    slots, gates, _, _, _ = tmoe._route(probs, 3, 8, cap)
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    want = torch.zeros(b, t, d)
    for bi in range(b):
        for e in range(8):             # expert order = the add order
            for c in range(cap):
                tok = int(slots[bi, e, c])
                if tok == t:
                    continue
                xi = x_pad[bi, tok][None, None]
                g = torch.nn.functional.silu(xi @ p["w_gate"][e])
                y = (g * (xi @ p["w_up"][e])) @ p["w_down"][e]
                want[bi, tok] += (y * gates[bi, e, c])[0, 0]
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-6, atol=1e-6)


# -- reduced MoE configs: decode and engine -------------------------------

P_LEN, GEN = 40, 8


@pytest.fixture(scope="module")
def moe_models():
    return {name: moe_model(name, P_LEN) for name in MOE_CFGS}


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_moe_decode_matches_jax(moe_models, name):
    """singular + confidence: identical tokens and steps, caches close;
    the SPA steps route their k gathered rows with a smaller capacity."""
    cfg, params, prompt = moe_models[name]
    with tmoe.count_drops() as drops:
        sess = dense_decode_parity(cfg, params, prompt, GEN, "singular")
    kind = cfg.layer_pattern[0]
    if cfg.cache_dtype == "int8":
        assert sess.state.cache[kind]["k"].dtype == torch.int8
    assert len(drops) > 2 * cfg.n_layers     # prefill + steps per layer
    assert "moe" in sess.params["blocks"][kind]


def test_moe_weights_bridge_checks_expert_shapes(moe_models):
    """``from_numpy_params`` carries the MoE leaves and refuses a tree
    whose experts do not match the config."""
    from repro_torch import weights
    cfg, params, _ = moe_models["mixtral-8x22b"]
    tcfg = port_cfg(cfg)
    tree = jax.tree.map(np.asarray, params)
    got = weights.from_numpy_params(tree, tcfg, "cpu")
    assert sorted(got["blocks"]["swa"]["moe"]) == [
        "router", "w_down", "w_gate", "w_up"]
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["swa"]["moe"]["w_up"] = np.zeros((2, 4, 128, 64),
                                                   np.float32)
    with pytest.raises(ValueError, match="moe.w_up"):
        weights.from_numpy_params(bad, tcfg, "cpu")
    shared = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_shared_experts=1, d_ff_shared=32))
    with pytest.raises(ValueError, match="moe.shared"):
        weights.from_numpy_params(tree, shared, "cpu")
