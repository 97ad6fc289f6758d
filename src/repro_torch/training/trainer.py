"""Training loop: masked-diffusion objective + AdamW, with gradient
accumulation over microbatches (the JAX package's ``training/trainer.py``).

The forward runs on ``dlm.loss.TRAINING_STRATEGY``, the ``TorchBackend``,
whose plain versions autograd differentiates (it is named, never chosen
by catching a failure of the CUDA path).  With
``cfg.remat`` each block is recomputed in the backward pass
(``torch.utils.checkpoint``, in ``models/transformer.forward_hidden``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.dlm.loss import diffusion_loss, encoder_loss
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, init_opt_state,
                                            tree_leaves, tree_unflatten)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    return encoder_loss if cfg.is_encoder_only else diffusion_loss


def _interleaved(x, nm: int, i: int):
    """Microbatch i of nm: row j is global row j * nm + i."""
    return x.reshape((x.shape[0] // nm, nm) + tuple(x.shape[1:]))[:, i]


def _slice_tree(tree, nm: int, i: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _slice_tree(v, nm, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice_tree(v, nm, i) for v in tree)
    return _interleaved(tree, nm, i)


def train_step(params, opt_state: OptState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, *,
               cfg: ModelConfig, opt_cfg: AdamWConfig, masking=None,
               strategy=None
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step on :func:`batch_grads`.  ``params`` are updated
    in place; returns (params, state, metrics)."""
    grads, metrics = batch_grads(params, batch, generator, cfg=cfg,
                                 masking=masking, strategy=strategy)
    params, opt_state, opt_metrics = adamw_update(
        opt_cfg, params, tree_unflatten(params, grads), opt_state)
    metrics.update(opt_metrics)
    return params, opt_state, metrics


def batch_grads(params, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, *,
                cfg: ModelConfig, masking=None, strategy=None):
    """The loss gradients of one batch, in ``tree_leaves(params)`` order,
    and the loss metrics; with ``cfg.microbatch`` > 1, accumulated over
    interleaved microbatches in ``cfg.accum_dtype`` and averaged (f32).
    ``masking`` is the whole batch's given masking (the loss's
    ``masking=``), split as the batch is; ``strategy`` is the loss's (the
    forward's backend)."""
    loss_fn = loss_fn_for(cfg)
    nm = max(cfg.microbatch, 1)
    leaves = tree_leaves(params)

    def grads_of(mb, mb_masking):
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, cfg, mb, generator,
                                    masking=mb_masking, strategy=strategy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    if nm == 1:
        grads, metrics = grads_of(batch, masking)
    else:
        acc_dt = torch_dtype(cfg.accum_dtype)
        # zeros_like: a sharded leaf's accumulator shards like the leaf
        acc = [torch.zeros_like(p, dtype=acc_dt) for p in leaves]
        ms = []
        for i in range(nm):
            g, m = grads_of(_slice_tree(batch, nm, i),
                            _slice_tree(masking, nm, i))
            for a, gi in zip(acc, g):
                a.add_(gi.to(acc_dt))
            ms.append(m)
            del g
        metrics = {k: torch.stack([m[k] for m in ms]).mean()
                   for k in ms[0]}
        grads = [(a if a.dtype == torch.float32 else a.float()).div_(nm)
                 for a in acc]
        del acc
    return grads, metrics


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.synthetic``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    opt_cfg: AdamWConfig
    params: Any = None
    opt_state: Optional[OptState] = None
    device: DeviceLike = None

    def init(self, seed: int = 0):
        from repro_torch.models import transformer
        self.device = resolve_device(self.device)
        self.params = transformer.init_params(self.cfg, seed,
                                              device=self.device)
        self.opt_state = init_opt_state(self.params)
        return self

    def fit(self, data_iter, n_steps: int, seed: int = 1,
            log_every: int = 10, log_fn=print) -> Dict[str, list]:
        """``n_steps`` steps on numpy batches from ``data_iter``, the
        masking drawn from a generator seeded with ``seed``."""
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        history = {"loss": [], "step_time": []}
        for step in range(n_steps):
            batch = batch_to_device(next(data_iter), dev)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = train_step(
                self.params, self.opt_state, batch, gen, cfg=self.cfg,
                opt_cfg=self.opt_cfg)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if log_every and step % log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"lr {float(metrics['lr']):.2e} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"({dt*1e3:.0f} ms)")
        return history
