"""AdamW with gradient clipping and a warmup-cosine LR schedule.

The port of the JAX package's ``training/optimizer.py``, step for step.
Parameters are a tree of dicts of tensors; the moments are f32 trees of
the same shape.  ``adamw_update`` updates the parameters and moments in
place: a bf16 parameter is updated through f32 and cast back, with no f32
master copy, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


_SLICE = 1 << 26


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar: completed updates
    mu: Any                 # f32 first moments, the params' tree
    nu: Any                 # f32 second moments


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s shape."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init_opt_state(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and the state's moments.
    A non-finite gradient norm zeroes the gradients (clip factor 0), so the
    moments only decay, as in JAX; only matrices (ndim >= 2) decay.
    Returns (params, new state, metrics)."""
    gnorm = global_norm(grads)
    ok = torch.isfinite(gnorm)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
    else:
        clip = torch.ones_like(gnorm)
    clip = torch.where(ok, clip, torch.zeros_like(clip))

    step = state.step + 1
    lr = lr_at(cfg, state.step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, n):
        decay = p.dim() >= 2            # decay matrices only
        # elementwise, so a large leaf goes in slices: its f32 temporaries
        # never exceed _SLICE elements each (a sharded leaf, a DTensor,
        # goes whole: each device updates its own shard)
        if type(p) is torch.Tensor:
            flat = [t.view(-1) for t in (p, g, m, n)]
            pieces = [[t[a:a + _SLICE] for t in flat]
                      for a in range(0, p.numel(), _SLICE)]
        else:
            pieces = [[p, g, m, n]]
        for sp, sg, sm, sn in pieces:
            sg = torch.nan_to_num(sg.float()).mul_(clip)
            sm.mul_(cfg.b1).add_(sg, alpha=1 - cfg.b1)
            sn.mul_(cfg.b2).addcmul_(sg, sg, value=1 - cfg.b2)
            delta = sm.div(b1c).div_(sn.div(b2c).sqrt_().add_(cfg.eps))
            p32 = sp.float()
            if decay:
                delta.add_(p32, alpha=cfg.weight_decay)
            sp.copy_(p32.sub_(delta.mul_(lr)))

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr,
        "nonfinite_grads": (~ok).float()}
