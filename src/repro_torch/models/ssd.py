"""Mamba-2 SSD (state-space duality) mixer, chunked algorithm.

The port of the JAX package's ``models/ssd.py``, term for term: input
projection into (z, xBC, dt), a short depthwise causal conv and SiLU on
xBC, the chunked SSD scan of arXiv:2405.21060 §6 over heads of
``head_dim`` with ``b`` and ``c`` shared by all heads (ngroups = 1), the
skip ``d_skip * x``, the SiLU(z) gate, an RMS norm and the output
projection.

The scan is causal, so for masked-diffusion denoising the block runs
both directions and averages (the bidirectional-SSM construction).
SPA-Cache sparse row updates are unsound for this mixer (a changed token
perturbs every later chunk state): the model runs with identifier
"none", a full recompute every refinement step.

The scan is the backend's ``ssd_scan`` stage: on ``CudaBackend`` the
hand-written kernel (``csrc/ssd_chunk.cu``) for tensors on the card, on
``TorchBackend`` the plain chunked version (the oracle).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.backend import CUDA_BACKEND, KernelBackend
from repro_torch.kernels.ssd_chunk import ssd_scan_ref  # noqa: F401
from repro_torch.models import common

_depthwise_conv = common.causal_conv   # x: [B, T, C], kernel: [W, C]


def init_ssd_params(cfg: ModelConfig, lk: int, dtype: torch.dtype,
                    device: torch.device, gen: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
    """Random mixer weights of ``lk`` stacked SSD blocks (leading [lk]
    axis on every leaf), the JAX package's shapes, scales and constants."""
    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    ds = ssm.d_state

    def dense(*shape, scale=None):
        return common.dense_init_(torch.empty(shape, dtype=dtype,
                                              device=device), gen, scale)

    def full(n, value):
        return torch.full((lk, n), value, dtype=dtype, device=device)

    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    return {
        "w_in": dense(lk, d, 2 * di + 2 * ds + nh),
        "conv_kernel": dense(lk, ssm.d_conv, di + 2 * ds, scale=0.1),
        "a_log": torch.from_numpy(a_log).to(device, dtype).expand(
            lk, nh).contiguous(),
        "dt_bias": full(nh, -3.0),          # softplus(-3) ~ 0.049
        "d_skip": full(nh, 1.0),
        "norm_weight": full(di, 0.0),
        "w_out": dense(lk, di, d),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, ``log1p(exp(-|x|)) + max(x, 0)`` (no threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp(x, min=0.0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
             backend: Optional[KernelBackend] = None) -> torch.Tensor:
    """Chunked SSD core: x [B, T, H, hd], dt [B, T, H] (positive step
    sizes), a [H] (negative decay rates), bmat, cmat [B, T, ds];
    T % chunk == 0.  Returns y [B, T, H, hd] in x's dtype."""
    b, t, h, _ = x.shape
    if t % chunk:
        raise ValueError(f"T = {t} is no multiple of the chunk {chunk}")
    dtf = dt.float()
    steps = dtf * a.float()[None, None, :]                # [B,T,H], <= 0
    la = torch.cumsum(steps.reshape(b, t // chunk, chunk, h),
                      dim=2).reshape(b, t, h)             # in-chunk
    return (backend or CUDA_BACKEND).ssd_scan(x, dtf, la, bmat, cmat, chunk)


def _ssd_one_direction(params, x: torch.Tensor, cfg: ModelConfig,
                       backend: Optional[KernelBackend]) -> torch.Tensor:
    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.n_heads(d)
    ds = ssm.d_state
    b, t, _ = x.shape

    proj = x @ params["w_in"]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * ds, nh], dim=-1)
    xbc = F.silu(_depthwise_conv(xbc, params["conv_kernel"]))
    x_ssm, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)
    x_ssm = x_ssm.reshape(b, t, nh, ssm.head_dim)
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())  # [B,T,H]
    a = -torch.exp(params["a_log"].float())                      # [H]

    chunk = min(ssm.chunk_size, t)
    pad = (-t) % chunk
    if pad:
        x_ssm = F.pad(x_ssm, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))

    y = ssd_scan(x_ssm, dt, a, bmat, cmat, chunk, backend)[:, :t]
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * x_ssm[:, :t]
    y = y.reshape(b, t, di)
    y = y * F.silu(z)
    y = common.rms_norm(y, params["norm_weight"], cfg.norm_eps)
    return y @ params["w_out"]


def apply_ssd(params, x: torch.Tensor, cfg: ModelConfig,
              bidirectional: bool = True,
              backend: Optional[KernelBackend] = None) -> torch.Tensor:
    """Full Mamba-2 mixer. x: [B, T, d] -> [B, T, d]; one scan launch per
    direction, through ``backend`` (``CudaBackend`` by default)."""
    y = _ssd_one_direction(params, x, cfg, backend)
    if bidirectional:
        y_rev = _ssd_one_direction(params, torch.flip(x, dims=(1,)), cfg,
                                   backend)
        y = 0.5 * (y + torch.flip(y_rev, dims=(1,)))
    return y
