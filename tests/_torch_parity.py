"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once, with numpy or the JAX package, and handed to both
packages as numpy arrays; the port runs on the CPU (``device="cpu"``),
single-threaded because the suite runs under several xdist workers.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch import weights


def port_cfg(cfg):
    """The JAX package's ModelConfig -> the port's (same field values)."""
    from repro_torch.configs.base import SPAConfig as TSPA
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["spa"] = TSPA(**dataclasses.asdict(cfg.spa))
    for name in ("moe", "ssm", "rglru"):
        assert fields[name] is None, f"{name} configs are not ported yet"
    return tconfigs.ModelConfig(**fields)


def port_params(params, tcfg):
    return weights.from_numpy_params(jax.tree.map(np.asarray, params),
                                     tcfg, "cpu")


def port_proxies(proxies, tcfg):
    return weights.from_numpy_proxies(jax.tree.map(np.asarray, proxies),
                                      tcfg, "cpu")


def np32(x):
    """Any array or tensor -> float32 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)
