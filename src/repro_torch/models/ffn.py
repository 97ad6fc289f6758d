"""Dense feed-forward blocks (gated and plain)."""
from __future__ import annotations

import torch

from repro_torch.models import common


def apply_ffn(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model]."""
    fn = common.act_fn(act)
    if "w_gate" in params:
        gate = fn(x @ params["w_gate"])
        up = x @ params["w_up"]
        return (gate * up) @ params["w_down"]
    h = fn(x @ params["w_up"] + params["b_up"])
    return h @ params["w_down"] + params["b_down"]
