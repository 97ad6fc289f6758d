"""PyTorch port vs the JAX package: training the recurrent stacks.

RecurrentGemma (RG-LRU, RG-LRU, local attention) and Mamba2 (SSD blocks),
reduced, on the same weights, batch and masking: ``diffusion_loss`` and
its gradients within 1e-4.  The port's RG-LRU recurrence and SSD scan run
their plain versions under autograd (the JAX model differentiates an XLA
associative scan and its chunked SSD scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data import synthetic as jdata
from repro.dlm import loss as jloss
from repro.dlm.noise import sample_masking as jmasking
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg, port_params
from repro_torch.dlm import loss as tloss
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch,layers", [("recurrentgemma-9b", 3),
                                         ("mamba2-370m", 2)])
def test_recurrent_diffusion_loss_and_grads_match_jax(arch, layers):
    cfg = reduced(get_arch(arch), n_layers=layers)
    tcfg = port_cfg(cfg)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    batch = next(jdata.token_batches(cfg, 2, 32, seed=0))
    rng = jax.random.PRNGKey(5)
    _, mask, t = jmasking(rng, jnp.asarray(batch["tokens"]), cfg.mask_id)
    (jl, _), jg = jax.jit(
        jax.value_and_grad(jloss.diffusion_loss, has_aux=True),
        static_argnums=(1,))(params, cfg,
                             {"tokens": jnp.asarray(batch["tokens"])}, rng)
    tp = port_params(params, tcfg)
    leaves = topt.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = tloss.diffusion_loss(
        tp, tcfg, {"tokens": torch.from_numpy(batch["tokens"])},
        masking=(torch.from_numpy(np.array(mask)),
                 torch.from_numpy(np.array(t))))
    tg = _leaves(topt.tree_unflatten(tp, torch.autograd.grad(tl, leaves)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4,
                               atol=1e-4)
    jgl = _leaves(jax.tree.map(np.asarray, jg))
    assert sorted(jgl) == sorted(tg)
    for name, g in jgl.items():
        np.testing.assert_allclose(np32(tg[name]), g, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
