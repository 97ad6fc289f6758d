"""Mixture-of-Experts FFN with capacity-based gather / scatter dispatch.

The port of the JAX package's ``models/moe.py``.  Each expert slot (e, c)
records the token index that fills it; the expert inputs are a gather, the
outputs a gate-weighted scatter-add, so the work scales with the experts'
capacity, not with the whole token set.

Routing follows the JAX ``_route_one`` exactly, including one behaviour
that is reproduced, not fixed: an assignment past an expert's capacity is
clamped to slot ``cap - 1`` and writes the sentinel token ``T`` there,
after the assignment that legitimately took that slot.  So every expert
that overflows loses its last slot; its gate stays in ``slot_gates`` but
its output lands in the discarded sentinel row.  The port writes that
outcome explicitly instead of relying on the order of duplicate-index
writes (undefined on CUDA).

The combine adds each token's contributions in the order of its experts'
indices, one gathered row per rank of the choice (a zero row where
capacity dropped the choice), so the sums never depend on thread order.
Routing, dispatch and combine write nothing in place: under a mesh (the
dry run) each is an op DTensor can shard.

The stages (``_dispatch``, ``_gather``, ``_experts``, ``_combine``) are
module functions, so a profiler can wrap each in a named range.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.selection import topk_lowest_first
from repro_torch.distributed.hints import shard_hint
from repro_torch.models import common, ffn

# set by ``count_drops``: a list collecting each call's dropped assignments
_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops():
    """Collect, for every ``apply_moe`` call inside the block, the number of
    token-to-expert assignments capacity dropped (a device scalar each; no
    host sync).  Yields the list."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def init_moe_params(cfg_moe: MoEConfig, d_model: int, act: str, lk: int,
                    empty, zeros, gen: torch.Generator):
    """Random leaves of ``lk`` stacked MoE blocks (router [lk, d, E],
    experts [lk, E, d, f] / [lk, E, f, d], optional ``shared`` FFN)."""
    e, f = cfg_moe.n_experts, cfg_moe.d_ff_expert
    p = {"router": common.dense_init_(empty(lk, d_model, e), gen),
         "w_gate": common.dense_init_(empty(lk, e, d_model, f), gen),
         "w_up": common.dense_init_(empty(lk, e, d_model, f), gen),
         "w_down": common.dense_init_(empty(lk, e, f, d_model), gen)}
    if cfg_moe.n_shared_experts:
        p["shared"] = ffn.init_ffn_params(
            d_model, cfg_moe.n_shared_experts * cfg_moe.d_ff_shared, act,
            lk, empty, zeros, gen)
    return p


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    cap = int(moe.top_k * n_tokens * moe.capacity_factor / moe.n_experts)
    return max(4, ((cap + 3) // 4) * 4)


def _route(probs: torch.Tensor, k: int, e: int, cap: int):
    """Per-sequence routing, batched.  probs: [B, T, E] f32.

    Returns (slots [B, E, cap] token index or T (sentinel), slot_gates
    [B, E, cap] f32, slot_rank [B, E, cap] (the rank of the slot's expert
    among its token's experts, by index), gate_idx [B, T, k], count [B, E]
    (the assignments each expert was offered))."""
    b, t, _ = probs.shape
    dev = probs.device
    gate_idx = topk_lowest_first(probs, k)                    # [B, T, k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    flat_expert = gate_idx.reshape(b, t * k)                  # [B, T*k]
    flat_gate = gate_vals.reshape(b, t * k)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(flat_expert, e)      # [B, T*k, E]
    # token-major position of each assignment among its expert's
    pos = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(pos, -1, flat_expert[..., None])[..., 0]
    count = onehot.sum(dim=1)                                 # [B, E]
    # every rejected assignment writes column ``cap``, which is dropped
    col = torch.where(slot < cap, slot, cap)
    rank = (gate_idx[..., None, :] < gate_idx[..., :, None]).sum(-1)
    # each row's [E, cap + 1] slots flattened: one out-of-place scatter a
    # table (the kept columns receive at most one write each)
    where = flat_expert * (cap + 1) + col                    # [B, T*k]

    def place(fill, vals, dtype):
        base = torch.full((b, e * (cap + 1)), fill, dtype=dtype, device=dev)
        return base.scatter(1, where, vals.to(dtype)).reshape(
            b, e, cap + 1)[..., :cap]

    slots = place(t, flat_token.expand(b, t * k), torch.long)
    gates = place(0.0, flat_gate, torch.float32)
    ranks = place(0, rank.reshape(b, t * k), torch.long)
    # the JAX sentinel overwrite: an overflowing expert's last slot (held
    # by the assignment that took it legitimately) reads the sentinel T
    last = torch.where(count > cap, t, slots[..., cap - 1])
    slots = torch.cat([slots[..., :cap - 1], last[..., None]], dim=-1)
    return slots, gates, ranks, gate_idx, count


def _dispatch(router: torch.Tensor, x: torch.Tensor, moe: MoEConfig,
              cap: int):
    """Router logits and softmax in f32, routing and the Switch aux loss
    (E * mean_e f_e * p_e).  Returns (slots, slot_gates, slot_rank, aux)."""
    e = moe.n_experts
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # [B, T, E]
    slots, gates, ranks, gate_idx, count = _route(probs, moe.top_k, e, cap)
    if _DROPS is not None:
        # rejected assignments, plus the last slot of each overflowing expert
        _DROPS.append((count - cap).clamp(min=0).sum()
                      + (count > cap).sum())
    me = probs.mean(dim=1)                                    # [B, E]
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], e).float().mean(1)
    aux = (me * ce).sum(-1).mean() * e
    return slots, gates, ranks, aux


def _gather(x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Expert inputs [B, E, C, d]; the sentinel row T reads zeros."""
    b, _, d = x.shape
    _, e, c = slots.shape
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)       # [B, T+1, d]
    idx = slots.reshape(b, e * c, 1).expand(b, e * c, d)
    return torch.gather(x_pad, 1, idx).reshape(b, e, c, d)


def _experts(params, expert_in: torch.Tensor, slot_gates: torch.Tensor,
             act: str) -> torch.Tensor:
    """The three batched expert products, gated: [B, E, C, d]."""
    fn = common.act_fn(act)
    # expert parallelism: E over "model" (dropped when E % model != 0)
    expert_in = shard_hint(expert_in, "batch", "model", None, None)
    gate = fn(torch.einsum("becd,edf->becf", expert_in, params["w_gate"]))
    up = torch.einsum("becd,edf->becf", expert_in, params["w_up"])
    out = torch.einsum("becf,efd->becd", gate * up, params["w_down"])
    out = shard_hint(out, "batch", "model", None, None)
    return out * slot_gates[..., None].to(out.dtype)


def _combine(expert_out: torch.Tensor, slots: torch.Tensor,
             slot_rank: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Scatter-add the expert rows back to their tokens: [B, T, d].

    A scatter first maps each (token, rank of choice) to the slot that
    holds it (a zero row where capacity dropped it; every real pair has at
    most one slot, the sentinel's duplicates land in a discarded row).
    Then, rank by rank, those rows are gathered and added to the token
    rows, starting from zeros: the sums, made in the order of the experts'
    indices, never depend on thread order."""
    b, e, c, d = expert_out.shape
    dev = expert_out.device
    src = torch.cat([expert_out.reshape(b, e * c, d),
                     expert_out.new_zeros(b, 1, d)], dim=1)  # last: zeros
    flat = torch.arange(e * c, device=dev).expand(b, e * c)
    inv = torch.full((b, (t + 1) * k), e * c, dtype=torch.long, device=dev)
    inv = inv.scatter(1, (slots * k + slot_rank).reshape(b, e * c),
                      flat).reshape(b, t + 1, k)
    out = expert_out.new_zeros(b, t, d)
    for r in range(k):
        idx = inv[:, :t, r, None].expand(b, t, d)
        out = out + torch.gather(src, 1, idx)
    return out


def apply_moe(params, x: torch.Tensor, moe: MoEConfig, act: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (out [B, T, d], Switch aux loss scalar f32).
    Capacity follows this call's token count T."""
    t = x.shape[1]
    slots, slot_gates, slot_rank, aux = _dispatch(
        params["router"], x, moe, _capacity(t, moe))
    expert_out = _experts(params, _gather(x, slots), slot_gates, act)
    out = _combine(expert_out, slots, slot_rank, t, moe.top_k)
    if "shared" in params:
        out = out + ffn.apply_ffn(params["shared"], x, act)
    return out.to(x.dtype), aux.float()
