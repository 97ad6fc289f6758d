"""Carry weights across frameworks as numpy arrays.

The JAX package's parameter pytree, mapped to numpy
(``jax.tree.map(np.asarray, params)``), has the layout the port uses:
``embed``, ``final_norm``, ``lm_head`` (untied models) and per-kind
stacked blocks ``blocks[kind][name]`` with a leading ``[L_kind]`` axis
(nested dicts too: an RG-LRU or SSD block's ``mixer`` and every block's
``ffn``).
``from_numpy_params`` turns it into the port's parameters leaf for leaf
(dtype kept, bfloat16 included), so both packages run the same weights;
``from_numpy_proxies`` does the same for a ``{kind: [Lk, d, r]}`` stack of
singular proxies, so both packages score with the same proxy matrices.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import (ATTENTION_KINDS, RGLRU, SSD, ModelConfig,
                                      SSMConfig)
from repro_torch.device import DeviceLike, resolve_device, torch_dtype

_NUMPY_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "int8": torch.int8, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}


def to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    """One numpy array -> torch tensor of the same dtype on ``device``.
    bfloat16 (numpy's ``ml_dtypes`` extension type) travels as its raw
    16-bit pattern."""
    a = np.array(arr, order="C", copy=True)   # writable, owned by torch
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name not in _NUMPY_DTYPES:
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def from_numpy_params(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy leaves) -> the port's
    parameters on ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    params = _convert(tree, dev)
    want = torch_dtype(cfg.param_dtype)
    if params["embed"].shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(params['embed'].shape)} does not "
                         f"match {cfg.name}")
    if params["embed"].dtype != want:
        raise TypeError(f"params are {params['embed'].dtype}, config "
                        f"says {want}")
    for kind, bp in params["blocks"].items():
        lk = cfg.n_layers_of_kind(kind)
        if kind in ATTENTION_KINDS:
            leaf, want_shape = "wq", (lk, cfg.d_model, cfg.q_dim)
            got = bp["wq"]
        elif kind == RGLRU:
            d_rnn = (cfg.rglru.d_rnn if cfg.rglru else None) or cfg.d_model
            leaf, want_shape = "mixer.w_in", (lk, cfg.d_model, d_rnn)
            got = bp["mixer"]["w_in"]
        elif kind == SSD:
            ssm = cfg.ssm or SSMConfig()
            di, nh = ssm.d_inner(cfg.d_model), ssm.n_heads(cfg.d_model)
            leaf = "mixer.w_in"
            want_shape = (lk, cfg.d_model, 2 * di + 2 * ssm.d_state + nh)
            got = bp["mixer"]["w_in"]
        else:
            raise NotImplementedError(f"layer kind {kind!r} waits for a "
                                      "later slice of the port")
        if got.shape != want_shape:
            raise ValueError(f"blocks[{kind!r}].{leaf} {tuple(got.shape)} "
                             f"does not match {cfg.name}")
    return params


def from_numpy_proxies(proxies: Dict[str, Any], cfg: ModelConfig,
                       device: DeviceLike = None
                       ) -> Dict[str, torch.Tensor]:
    """A ``{kind: [Lk, d, r]}`` singular-proxy stack (numpy) -> tensors."""
    dev = resolve_device(device)
    out = {kind: to_tensor(stack, dev) for kind, stack in proxies.items()}
    for kind, stack in out.items():
        if stack.shape[:2] != (cfg.n_layers_of_kind(kind), cfg.d_model):
            raise ValueError(f"proxies[{kind!r}] {tuple(stack.shape)}")
    return out
