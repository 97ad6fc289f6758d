"""Masked-diffusion decoding canvas."""
from __future__ import annotations

import torch


def mask_canvas(prompt: torch.Tensor, gen_len: int,
                mask_id: int) -> torch.Tensor:
    """Decoding canvas: prompt followed by gen_len [MASK] slots."""
    b, p = prompt.shape
    canvas = torch.full((b, p + gen_len), mask_id, dtype=prompt.dtype,
                        device=prompt.device)
    canvas[:, :p] = prompt
    return canvas
