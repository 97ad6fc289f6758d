"""Masked-diffusion forward process (LLaDA / MDLM style) and the decoding
canvas."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_masking(tokens: torch.Tensor, mask_id: int,
                   generator: Optional[torch.Generator] = None,
                   min_t: float = 0.05, max_t: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-example mask ratio t ~ U(min_t, max_t), each token masked i.i.d.
    with probability t, the draws from ``generator`` (on the tokens'
    device).  The JAX package draws from ``jax.random``, which torch cannot
    reproduce: to compare the two, pass a given masking to the losses.

    Returns (noisy tokens, mask [B, T] bool, t [B] f32)."""
    b, n = tokens.shape
    dev = tokens.device
    t = torch.rand((b,), generator=generator, device=dev) \
        * (max_t - min_t) + min_t
    mask = torch.rand((b, n), generator=generator, device=dev) < t[:, None]
    return masked_tokens(tokens, mask, mask_id), mask, t


def masked_tokens(tokens: torch.Tensor, mask: torch.Tensor,
                  mask_id: int) -> torch.Tensor:
    """``tokens`` with [MASK] where ``mask`` holds."""
    return torch.where(mask, torch.full_like(tokens, mask_id), tokens)


def mask_canvas(prompt: torch.Tensor, gen_len: int,
                mask_id: int) -> torch.Tensor:
    """Decoding canvas: prompt followed by gen_len [MASK] slots."""
    b, p = prompt.shape
    canvas = torch.full((b, p + gen_len), mask_id, dtype=prompt.dtype,
                        device=prompt.device)
    canvas[:, :p] = prompt
    return canvas
