"""Dense feed-forward blocks (gated and plain)."""
from __future__ import annotations

import torch

from repro_torch.distributed.hints import shard_hint
from repro_torch.models import common


def init_ffn_params(d: int, f: int, act: str, lk: int, empty, zeros,
                    gen: torch.Generator):
    """Random leaves of ``lk`` stacked FFNs: gated (silu / gelu) or plain
    with biases; ``empty`` / ``zeros`` allocate in the model's dtype."""
    if act in ("silu", "gelu"):
        return {"w_gate": common.dense_init_(empty(lk, d, f), gen),
                "w_up": common.dense_init_(empty(lk, d, f), gen),
                "w_down": common.dense_init_(empty(lk, f, d), gen)}
    return {"w_up": common.dense_init_(empty(lk, d, f), gen),
            "b_up": zeros(lk, f),
            "w_down": common.dense_init_(empty(lk, f, d), gen),
            "b_down": zeros(lk, d)}


def apply_ffn(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: [..., d_model] -> [..., d_model].  The row-parallel w_down
    all-reduce is pinned at the dot output (see ``qkv_project``)."""

    def pin(y):
        return shard_hint(y, *(["batch"] + ["keep"] * (y.dim() - 2)
                               + [None]))

    fn = common.act_fn(act)
    if "w_gate" in params:
        gate = fn(x @ params["w_gate"])
        up = x @ params["w_up"]
        return pin((gate * up) @ params["w_down"])
    h = fn(x @ params["w_up"] + params["b_up"])
    return pin(h @ params["w_down"] + params["b_down"])
