"""RG-LRU recurrent block (Griffin / RecurrentGemma), bidirectional.

The port of the JAX package's ``models/rglru.py``, term for term:

  input proj -> short causal temporal conv -> gated linear recurrence
    r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  in parallel with a tanh-GELU gate branch, merged by an elementwise
  product and an output projection.

Masked-diffusion decoding needs bidirectional context, so the recurrence
runs forward and on the flipped sequence, and the two are averaged.  The
gates are block-diagonal (``n_heads`` blocks) and computed in f32; ``a``
and the gated input are cast to the model dtype before the recurrence,
which keeps an f32 carry.  The recurrence is the backend's ``rglru_scan``
stage (``CudaBackend``: the CUDA kernel on the card, its plain loop on the
CPU; ``TorchBackend``: the plain loop anywhere), where the JAX model runs
an XLA associative scan.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import CUDA_BACKEND, KernelBackend
from repro_torch.models import common

_C = 8.0  # Griffin's gate sharpness constant


def _gate_heads(cfg: ModelConfig, dr: int) -> int:
    nb = cfg.rglru.n_heads if (cfg.rglru and cfg.rglru.n_heads) else 1
    while dr % nb:
        nb -= 1
    return max(nb, 1)


def init_rglru_params(cfg: ModelConfig, lk: int, dtype: torch.dtype,
                      device: torch.device, gen: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Random mixer weights of ``lk`` stacked RG-LRU blocks (leading
    [lk] axis on every leaf), the JAX package's shapes and scales."""
    d = cfg.d_model
    dr = (cfg.rglru.d_rnn or d) if cfg.rglru else d
    conv_w = cfg.rglru.conv_width if cfg.rglru else 4
    nb = _gate_heads(cfg, dr)
    c = dr // nb

    def dense(*shape, scale=None):
        return common.dense_init_(torch.empty(shape, dtype=dtype,
                                              device=device), gen, scale)

    def full(value):
        return torch.full((lk, dr), value, dtype=dtype, device=device)

    return {
        "w_in": dense(lk, d, dr),
        "w_gate_branch": dense(lk, d, dr),
        "conv_kernel": dense(lk, conv_w, dr, scale=0.1),
        "w_a": dense(lk, nb, c, c),
        "b_a": full(0.0),
        "w_x": dense(lk, nb, c, c),
        "b_x": full(0.0),
        "log_lambda": full(-1.0),
        "w_out": dense(lk, dr, d),
    }


_temporal_conv = common.causal_conv   # x: [B, T, dr], kernel: [W, dr]


def _block_gate(xf: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal gate in f32: xf [B, T, dr], w [nb, c, c] ->
    [B, T, dr]."""
    bsz, t, dr = xf.shape
    nb, c, _ = w.shape
    out = torch.einsum("btnc,nck->btnk", xf.reshape(bsz, t, nb, c),
                       w.float())
    return torch.sigmoid(out.reshape(bsz, t, dr) + b.float())


def rglru_core(params, x: torch.Tensor, *, reverse: bool = False,
               backend: Optional[KernelBackend] = None) -> torch.Tensor:
    """The gated linear recurrence on pre-activations x: [B, T, dr]; the
    scan on ``backend`` (default ``CUDA_BACKEND``)."""
    if reverse:
        x = torch.flip(x, dims=(1,))
    xf = x.float()
    r = _block_gate(xf, params["w_a"], params["b_a"])
    i = _block_gate(xf, params["w_x"], params["b_x"])
    lam = params["log_lambda"].float()
    decay = torch.logaddexp(lam, torch.zeros_like(lam))   # softplus
    a = torch.exp(-_C * decay * r)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    # the recurrence streams in the model dtype (f32 carry)
    h = (backend or CUDA_BACKEND).rglru_scan(a.to(x.dtype),
                                             gated_in.to(x.dtype))
    if reverse:
        h = torch.flip(h, dims=(1,))
    return h.to(x.dtype)


def apply_rglru(params, x: torch.Tensor, cfg: ModelConfig,
                bidirectional: bool = True,
                backend: Optional[KernelBackend] = None) -> torch.Tensor:
    """Full RG-LRU mixer. x: [B, T, d] -> [B, T, d]; the scans on
    ``backend``."""
    pre = x @ params["w_in"]
    pre = _temporal_conv(pre, params["conv_kernel"])
    h = rglru_core(params, pre, backend=backend)
    if bidirectional:
        h = 0.5 * (h + rglru_core(params, pre, reverse=True,
                                  backend=backend))
    gate = common.act_fn("gelu")(x @ params["w_gate_branch"])
    return (gate * h) @ params["w_out"]
