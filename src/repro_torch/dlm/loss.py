"""Masked-diffusion training objective (LLaDA style) with chunked CE.

The port of the JAX package's ``dlm/loss.py``.  The lm-head logits over a
large vocabulary are computed in sequence chunks, each under
``torch.utils.checkpoint``, so only one chunk's [B, chunk, V] logits are
alive at a time and the backward pass recomputes them chunk by chunk.

The forward runs on :data:`TRAINING_STRATEGY`, whose backend is the
``TorchBackend``: the JAX training path reaches no Pallas kernel (its
attention is the XLA ``flash_attention``, its recurrences XLA scans), and
the port's counterpart is the plain PyTorch versions, which autograd
differentiates.  The CUDA kernels have no backward; they serve decoding.

The JAX losses draw their masking from ``jax.random``, which torch cannot
reproduce; each loss here draws from a ``torch.Generator`` or takes a
given masking.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.strategy import NoCache
from repro_torch.dlm.noise import masked_tokens, sample_masking
from repro_torch.kernels.backend import TORCH_BACKEND
from repro_torch.models import common, transformer

# the cache-less strategy whose backend runs the training forward
TRAINING_STRATEGY = NoCache(backend=TORCH_BACKEND)


def _chunk_size(cfg: ModelConfig, n: int) -> int:
    # keep chunk * V bounded (~16M elements)
    target = max(64, int(2 ** 24 // max(cfg.vocab_size, 1)))
    c = min(n, target)
    while n % c:
        c -= 1
    return max(c, 1)


def _chunk_nll(h_i: torch.Tensor, t_i: torch.Tensor, table: torch.Tensor,
               softcap: float) -> torch.Tensor:
    logits = (h_i @ table).float()
    if softcap > 0:
        logits = common.softcap(logits, softcap)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, t_i[..., None].long())[..., 0]


def chunked_token_nll(params, cfg: ModelConfig, h: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """-log p(target) per token from final hidden states, chunked over N.
    h: [B, N, d]; targets: [B, N] -> nll [B, N] f32."""
    b, n, _ = h.shape
    c = _chunk_size(cfg, n)
    h_n = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = []
    for s in range(0, n, c):
        h_i, t_i = h_n[:, s:s + c], targets[:, s:s + c]
        if h_i.requires_grad:
            out.append(torch.utils.checkpoint.checkpoint(
                _chunk_nll, h_i, t_i, table, cfg.logit_softcap,
                use_reentrant=False))
        else:
            out.append(_chunk_nll(h_i, t_i, table, cfg.logit_softcap))
    return torch.cat(out, dim=1)


def diffusion_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   masking: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   strategy=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens": [B, T]} (plus a VLM's "patches" [B, F, d]).
    ``masking`` = (mask [B, T] bool, t [B]) replaces the draw from
    ``generator``; ``strategy`` (default :data:`TRAINING_STRATEGY`) carries
    the forward's backend.  Returns (loss, metrics).  LLaDA ELBO: mean_b
    [(1/t_b) sum_masked nll / T], plus ``router_aux_weight * aux`` for a
    MoE."""
    tokens = batch["tokens"]
    b, n = tokens.shape
    if masking is None:
        noisy, mask, t = sample_masking(tokens, cfg.mask_id, generator)
    else:
        mask, t = masking
        noisy = masked_tokens(tokens, mask, cfg.mask_id)
    inputs = dict(batch)
    inputs["tokens"] = noisy
    h = transformer.embed_inputs(params, cfg, inputs)
    h, aux, _ = transformer.forward_hidden(
        params, cfg, h, strategy=strategy or TRAINING_STRATEGY)
    if cfg.frontend == "vision":
        h = h[:, batch["patches"].shape[1]:]
    nll = chunked_token_nll(params, cfg, h, tokens)
    per_tok = nll * mask.float()
    per_ex = per_tok.sum(-1) / (t.float().clamp(min=1e-3) * n)
    ce = per_ex.mean()
    total = ce + (cfg.moe.router_aux_weight * aux if cfg.moe else 0.0)
    metrics = {"loss": total, "ce": ce, "aux": aux,
               "mask_frac": mask.float().mean()}
    return total, metrics


def encoder_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 masking: Optional[torch.Tensor] = None, strategy=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """HuBERT-style masked-frame cluster prediction (encoder-only):
    batch {"frames": [B, T, d], "targets": [B, T]}; each frame masked with
    probability 0.3 (``masking``, a [B, T] bool mask, replaces the draw)."""
    frames, targets = batch["frames"], batch["targets"]
    b, n, _ = frames.shape
    mask = masking if masking is not None else torch.rand(
        (b, n), generator=generator, device=frames.device) < 0.3
    frames = torch.where(mask[..., None], torch.zeros_like(frames), frames)
    h = transformer.embed_inputs(params, cfg, {"frames": frames})
    h, aux, _ = transformer.forward_hidden(
        params, cfg, h, strategy=strategy or TRAINING_STRATEGY)
    nll = chunked_token_nll(params, cfg, h, targets)
    maskf = mask.float()
    loss = (nll * maskf).sum() / maskf.sum().clamp(min=1.0)
    return loss, {"loss": loss, "aux": aux, "mask_frac": maskf.mean()}
