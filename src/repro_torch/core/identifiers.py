"""Update identifiers (paper §3.2, Table 1; §3.3 singular proxy).

Given identifier vectors of the layer's CURRENT inputs and those cached at
each row's last refresh, the score is their rowwise cosine (LOW = drifted
= update).  The identifiers, as in the JAX package:

  value     — p = h @ W_v                (dLLM-Cache)
  singular  — p = h @ (U_r S_r)          (the paper's proxy)
  query/key — p = h @ W_q / W_k          (Table-1 ablations)
  attn_in   — p = h                      (Table-1 ablation)
  attn_out  — the latest full attention output (Table-1 ablation)
  window    — dKV-Cache-style locality: rows near recently committed
              tokens score low (are updated); no projection.
  none      — no cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.proxy_score import cosine


def proxy_project(h: torch.Tensor, identifier: str, *,
                  w_value: Optional[torch.Tensor] = None,
                  w_query: Optional[torch.Tensor] = None,
                  w_key: Optional[torch.Tensor] = None,
                  proxy_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project input states to identifier vectors p. h: [B,N,d] -> [B,N,r].

    Deprecated shim, as in the JAX package: the projection lives on
    ``CacheStrategy.project``; this resolves the identifier string through
    the strategy registry for old callers."""
    from repro_torch.core.strategy import REGISTRY
    cls = REGISTRY.get(identifier)
    if cls is None or identifier in ("none", "window", "attn_out"):
        raise ValueError(f"identifier {identifier!r} has no projection")
    strat = (cls() if identifier == "singular"
             else cls(projection=identifier))
    return strat.project(h, {"wv": w_value, "wq": w_query, "wk": w_key},
                         proxy_mat)


def drift_scores(p_now: torch.Tensor, p_cached: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """Similarity scores [B, N] (f32); low = drifted."""
    return cosine(p_now, p_cached, eps)


def locality_scores(n: int, committed_pos: torch.Tensor,
                    window: int) -> torch.Tensor:
    """dKV-Cache heuristic.  committed_pos: [B, C] recently committed
    positions (-1 = unused slot).  Returns [B, N] f32: the distance to the
    nearest committed position over ``window``, clipped to [0, 1], so rows
    within the window of a commit score low (update) and the rest 1."""
    pos = torch.arange(n, device=committed_pos.device)[None, None, :]
    cp = committed_pos.long()[:, :, None]                     # [B, C, 1]
    dist = torch.where(cp >= 0, (pos - cp).abs(),
                       torch.full_like(pos - cp, n + 1))
    min_dist = dist.amin(dim=1)                                # [B, N]
    return torch.clamp(min_dist.float() / max(window, 1), 0.0, 1.0)
