"""Shared model primitives: norms, RoPE, activations, inits, softcaps."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, cast back."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    if name in ("silu", "swish"):
        return F.silu
    if name in ("gelu", "gelu_plain"):
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along T as a sum of shifted products in x's
    dtype, taps in the JAX reference's order (no ``F.conv1d``: cuDNN's f32
    convolution is TF32 by default).  x: [B, T, C], kernel: [W, C]."""
    w, t = kernel.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + pads[:, i:i + t] * kernel[w - 1 - i]
    return out


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(half, dtype=np.float32) * 2 / head_dim))


@functools.lru_cache(maxsize=None)
def _device_frequencies(head_dim: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """The numpy frequencies on ``device``, copied there once (a host to
    device copy on every call would stall the stream twice per layer).
    Callers only read the tensor."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation. x: [..., S, H, D]; positions: [..., S]."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = _device_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs                 # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    parts = [out1, out2]
    if head_dim % 2:
        parts.append(x[..., 2 * half:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter init (explicit generator; values differ from jax.random's)
# ---------------------------------------------------------------------------

def dense_init_(out: torch.Tensor, generator: torch.Generator,
                scale: float | None = None,
                chunk_elems: int = 1 << 24) -> torch.Tensor:
    """Fill ``out`` ([..., d_in, d_out]) with N(0, 1/d_in) in place, a
    chunk of rows at a time so no f32 copy of a whole tensor is ever live."""
    fan_in = out.shape[-2] if out.dim() >= 2 else out.shape[-1]
    if scale is None:
        scale = 1.0 / np.sqrt(fan_in)
    rows = out.view(-1, out.shape[-1])
    step = max(1, chunk_elems // out.shape[-1])
    for a in range(0, rows.shape[0], step):
        sl = rows[a:a + step]
        sl.copy_(torch.randn(sl.shape, generator=generator,
                             device=out.device, dtype=torch.float32)
                 .mul_(scale))
    return out


def embed_init_(out: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    return dense_init_(out, generator, scale=0.02)
