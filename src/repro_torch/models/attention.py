"""Bidirectional attention with ``flash_attention``'s semantics.

The JAX package computes prefill attention with an XLA flash scan and the
gathered-query SPA step with the Pallas ``sparse_attention`` kernel; both
share one online-softmax step.  The port has ONE implementation of that
math: ``kernels.sparse_attention`` (a CUDA kernel on the card, its plain
PyTorch version on the CPU).  ``flash_attention`` here is the plain
version under the JAX function's name and signature, with contiguous query
positions by default; ``band_width`` and ``banded_starts``, the banded
grid's formulas, are the kernel module's, re-exported under the JAX names.
``attention_hints`` holds the JAX function's sharding hints; the plain
backend applies them, so they shape a step traced under a mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.hints import shard_hint
from repro_torch.kernels.sparse_attention import (NEG_INF, band_for,
                                                  band_width, banded_starts,
                                                  sparse_attention_plain)

__all__ = ["NEG_INF", "attention_hints", "band_width", "banded_starts",
           "flash_attention"]


def attention_hints(q, k, v, k_scale=None, v_scale=None):
    """Attention is model-axis-local: the row-parallel projections'
    all-reduces land before it, and a sequence-sharded KV cache is
    gathered ONCE per layer, not once per kv block.  Identity on plain
    tensors."""
    q = shard_hint(q, "batch", "keep", None, None)
    k = shard_hint(k, "batch", None, None, None)
    v = shard_hint(v, "batch", None, None, None)
    if k_scale is not None:
        k_scale = shard_hint(k_scale, "batch", None, None)
        v_scale = shard_hint(v_scale, "batch", None, None)
    return q, k, v, k_scale, v_scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    window: int = 0, soft_cap: float = 0.0,
                    block_q: int = 512, block_k: int = 512,
                    banded: bool = False, q_span: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Skv, KVH, D] (int8 with scales).
    q_positions: [B, Sq], default arange (contiguous: the span of a q block
    is ``min(block_q, Sq)``).  ``banded`` with a ``q_span`` bound runs the
    banded grid where it engages.  Returns [B, Sq, H, D] in q.dtype."""
    q, k, v, k_scale, v_scale = attention_hints(q, k, v, k_scale, v_scale)
    b, sq = q.shape[:2]
    skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
        q_span = min(block_q, sq)
    band = band_for(q_positions, skv, window, q_span, banded=banded,
                    block_q=block_q, block_k=block_k)
    return sparse_attention_plain(q, k, v, q_positions, k_scale=k_scale,
                                  v_scale=v_scale, window=window,
                                  soft_cap=soft_cap, kv_len=kv_len,
                                  block_k=block_k, band=band)
