"""Update identifiers (paper §3.2): drift scoring.

Given identifier vectors of the layer's CURRENT inputs and those cached at
each row's last refresh, the score is their rowwise cosine (LOW = drifted
= update).  The other identifiers of the JAX package (locality, the
Table-1 projections) wait for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.proxy_score import cosine


def drift_scores(p_now: torch.Tensor, p_cached: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """Similarity scores [B, N] (f32); low = drifted."""
    return cosine(p_now, p_cached, eps)
