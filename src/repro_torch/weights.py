"""Carry weights across frameworks as numpy arrays.

The JAX package's parameter pytree, mapped to numpy
(``jax.tree.map(np.asarray, params)``), has the layout the port uses:
``embed``, ``final_norm``, ``lm_head`` (untied models) and per-kind
stacked blocks ``blocks[kind][name]`` with a leading ``[L_kind]`` axis
(nested dicts too: an RG-LRU or SSD block's ``mixer``, a block's ``ffn``
or a MoE block's ``moe`` with its optional ``shared`` FFN), plus
``pos_embed`` for learned positions.
``from_numpy_params`` turns it into the port's parameters leaf for leaf
(dtype kept, bfloat16 included), so both packages run the same weights
(a checkpoint's tree from ``training.checkpoint.load_checkpoint`` goes the
same way); ``from_numpy_proxies`` does the same for a ``{kind: [Lk, d, r]}`` stack of
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

_POST_NORMS = {"norm_post_attn", "norm_post_ffn"}


def to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    """One numpy array -> torch tensor of the same dtype on ``device``.
    bfloat16 (numpy's ``ml_dtypes`` extension type) travels as its raw
    16-bit pattern.  A tensor (a loaded checkpoint's leaf) is copied to
    ``device`` as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to(device, copy=True)
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
    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError(f"lm_head {'present' if cfg.tie_embeddings else 'missing'}"
                         f": {cfg.name} has tie_embeddings="
                         f"{cfg.tie_embeddings}")
    if cfg.max_position:
        _check_shape(params, "pos_embed", (cfg.max_position, cfg.d_model),
                     cfg)
    elif "pos_embed" in params:
        raise ValueError(f"pos_embed present: {cfg.name} has no learned "
                         "positions")
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
        if kind in ATTENTION_KINDS:
            _check_ffn_or_moe(bp, kind, lk, cfg)
        post = _POST_NORMS & set(bp)
        if kind != SSD and post != (_POST_NORMS if cfg.post_norms
                                    else set()):
            raise ValueError(f"blocks[{kind!r}] post-norms {sorted(post)} "
                             f"do not match {cfg.name}")
    return params


def _check_shape(tree, leaf: str, want, cfg: ModelConfig) -> None:
    """``tree``'s dotted ``leaf`` must exist with shape ``want``."""
    got = tree
    for part in leaf.split("."):
        if not isinstance(got, dict) or part not in got:
            raise ValueError(f"{leaf} missing: {cfg.name} needs it")
        got = got[part]
    if tuple(got.shape) != tuple(want):
        raise ValueError(f"{leaf} {tuple(got.shape)} does not match "
                         f"{cfg.name} {tuple(want)}")


def _check_ffn_or_moe(bp, kind: str, lk: int, cfg: ModelConfig) -> None:
    """An attention block of a MoE config carries ``moe.{router, w_gate,
    w_up, w_down}`` (and ``moe.shared.*`` with shared experts), each of the
    config's shape; any other config's carries no ``moe``."""
    m, d = cfg.moe, cfg.d_model
    if m is None:
        if "moe" in bp:
            raise ValueError(f"blocks[{kind!r}].moe present: {cfg.name} "
                             "has no MoE")
        return
    e, f = m.n_experts, m.d_ff_expert
    want = {"router": (lk, d, e), "w_gate": (lk, e, d, f),
            "w_up": (lk, e, d, f), "w_down": (lk, e, f, d)}
    if m.n_shared_experts:
        fs = m.n_shared_experts * m.d_ff_shared
        want.update({"shared.w_up": (lk, d, fs),
                     "shared.w_down": (lk, fs, d)})
        if cfg.act in ("silu", "gelu"):
            want["shared.w_gate"] = (lk, d, fs)
    elif "shared" in bp.get("moe", {}):
        raise ValueError(f"blocks[{kind!r}].moe.shared present: {cfg.name} "
                         "has no shared experts")
    for leaf, shape in want.items():
        _check_shape(bp, f"moe.{leaf}", shape, cfg)


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
