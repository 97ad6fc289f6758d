"""Dense masked-diffusion transformer assembled from a ``ModelConfig``.

The port of the JAX package's ``models/transformer.py``: attention layer
kinds with a dense FFN (LLaDA / InternLM2 shapes) or a MoE FFN (Mixtral,
Qwen3-MoE), the RG-LRU hybrid (RecurrentGemma), the attention-free SSD
stack (Mamba2) and the stub frontends (vision patches prepended to the
text, audio frames with learned positions).
Parameters keep the JAX layout: a plain dict with ``embed``,
``final_norm``, ``lm_head`` (when untied) and per-kind STACKED blocks
``blocks[kind][name]`` with a leading ``[L_kind]`` axis, so the JAX
package's weights carry over leaf for leaf (``repro_torch.weights``).
The layer loop is unrolled, so a hybrid needs no period plan (JAX scans
a period only to compile it as one loop); ``cfg.remat`` checkpoints each
block when the forward records gradients.

Attention and the SSD scan go through the strategy's ``KernelBackend`` (the
CUDA kernels on the card); attention with contiguous query positions, so
prefill and the SPA step share one attention implementation.  Training
names the ``TorchBackend``, whose plain versions autograd differentiates
(the JAX training path runs XLA there, no Pallas kernel).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ATTENTION_KINDS, ATTN_LOCAL, ATTN_SWA,
                                      RGLRU, SSD, ModelConfig)
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.distributed.hints import shard_hint
from repro_torch.models import common, ffn, moe, rglru, ssd

Params = Dict[str, Any]


def layer_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind in (ATTN_SWA, ATTN_LOCAL) else 0


def _check_supported(cfg: ModelConfig) -> None:
    ported = set(ATTENTION_KINDS) | {RGLRU, SSD}
    kinds = set(cfg.layer_kinds)
    if not kinds <= ported:
        raise NotImplementedError(f"layer kinds {sorted(kinds - ported)}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Params:
    """Random weights in ``cfg.param_dtype`` on ``device`` (the card unless
    the caller names another), drawn from one seeded ``torch.Generator``
    tensor by tensor (no f32 copy of the model).  The values differ from
    the JAX package's ``jax.random`` init; carry JAX weights across with
    ``repro_torch.weights.from_numpy_params`` instead.  On ``"meta"`` the
    tree holds shapes and dtypes only (the dry run's abstract params)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: Params = {
        "embed": common.embed_init_(empty(cfg.vocab_size, d), gen),
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init_(empty(d, cfg.vocab_size), gen)
    if cfg.max_position:
        params["pos_embed"] = common.embed_init_(empty(cfg.max_position, d),
                                                 gen)
    blocks: Dict[str, Params] = {}
    for kind in sorted(set(cfg.layer_kinds)):
        lk = cfg.n_layers_of_kind(kind)
        gen.manual_seed(seed + zlib.crc32(kind.encode()) % (2 ** 31))
        if kind == RGLRU:
            bp: Params = {
                "norm1": zeros(lk, d),
                "mixer": rglru.init_rglru_params(cfg, lk, dtype, dev, gen),
                "norm2": zeros(lk, d)}
        elif kind == SSD:     # norm2 + FFN only when d_ff > 0
            bp = {"norm1": zeros(lk, d),
                  "mixer": ssd.init_ssd_params(cfg, lk, dtype, dev, gen)}
            if cfg.d_ff > 0:
                bp["norm2"] = zeros(lk, d)
        else:
            bp = {
                "norm1": zeros(lk, d),
                "wq": common.dense_init_(empty(lk, d, cfg.q_dim), gen),
                "wk": common.dense_init_(empty(lk, d, cfg.kv_dim), gen),
                "wv": common.dense_init_(empty(lk, d, cfg.kv_dim), gen),
                "wo": common.dense_init_(empty(lk, cfg.q_dim, d), gen),
                "norm2": zeros(lk, d),
            }
        if cfg.moe is not None and kind in ATTENTION_KINDS:
            bp["moe"] = moe.init_moe_params(cfg.moe, d, cfg.act, lk, empty,
                                            zeros, gen)
        elif cfg.d_ff > 0:
            bp["ffn"] = ffn.init_ffn_params(d, cfg.d_ff, cfg.act, lk, empty,
                                            zeros, gen)
        if cfg.post_norms and kind != SSD:
            bp["norm_post_attn"] = zeros(lk, d)
            bp["norm_post_ffn"] = zeros(lk, d)
        blocks[kind] = bp
    params["blocks"] = blocks
    return params


def layer_params(params: Params, cfg: ModelConfig, l: int) -> Params:
    """Layer ``l``'s block params (views into the per-kind stacks)."""
    kind = cfg.kind_of_layer(l)
    ki = cfg.kind_index(l)
    return _index_tree(params["blocks"][kind], ki)


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ModelConfig,
                 inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """inputs: {"tokens": [B, T]} | {"frames": [B, T, d]} (audio) |
    {"tokens": [B, T_text], "patches": [B, F, d]} (vision: the patches
    come first) -> h0 [B, N, d]; learned positions added when the config
    has them."""
    _check_supported(cfg)
    if cfg.frontend == "audio":
        h = inputs["frames"].to(torch_dtype(cfg.param_dtype))
    elif cfg.frontend == "vision":
        text = params["embed"][inputs["tokens"].long()]
        h = torch.cat([inputs["patches"].to(text.dtype), text], dim=1)
    else:
        h = params["embed"][inputs["tokens"].long()]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    if cfg.max_position:
        h = h + params["pos_embed"][:h.shape[1]][None]
    return h


# ---------------------------------------------------------------------------
# Block application (dense path)
# ---------------------------------------------------------------------------

def qkv_project(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x: [B,S,d] (already normed) -> q [B,S,H,hd], k/v [B,S,KVH,hd].

    Under a mesh the row-parallel partial-sum all-reduce is pinned HERE,
    at the dot output, before rope's f32 math."""
    b, s, _ = x.shape

    def proj(w):
        return shard_hint(x @ w, "batch", "keep", None)

    q = proj(bp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = proj(bp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = proj(bp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if not cfg.max_position:   # rope unless learned absolute positions
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_ffn_or_moe(bp: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(FFN or MoE output, the MoE aux loss or 0); a MoE routes with the
    capacity of x's own token count."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in bp:
        return moe.apply_moe(bp["moe"], x, cfg.moe, cfg.act)
    if "ffn" in bp:
        return ffn.apply_ffn(bp["ffn"], x, cfg.act), zero
    return torch.zeros_like(x), zero


def apply_block_dense(cfg: ModelConfig, kind: str, bp: Params,
                      h: torch.Tensor, *, collect_cache: bool = False,
                      proxy_mat: Optional[torch.Tensor] = None,
                      strategy=None,
                      kv_len: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[Dict[str, torch.Tensor]]]:
    """One block over the full sequence.  Returns (h_out, aux loss, cache
    entries or None); an attention block's entries hold the raw k/v/h (+
    proxy) tensors, a recurrent block keeps no cache."""
    from repro_torch.core.strategy import resolve_strategy
    strat = resolve_strategy(cfg, strategy)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == RGLRU:
        return _apply_rglru_block(cfg, bp, h, strat.backend), zero, None
    if kind == SSD:
        return _apply_ssd_block(cfg, bp, h, strat.backend), zero, None
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}")
    b, n, _ = h.shape
    x = common.rms_norm(h, bp["norm1"], cfg.norm_eps)
    positions = torch.arange(n, device=h.device).expand(b, n)
    q, k, v = qkv_project(bp, x, cfg, positions)
    attn = strat.backend.attention(q, k, v, window=layer_window(cfg, kind),
                                   soft_cap=cfg.attn_softcap,
                                   banded=layer_window(cfg, kind) > 0,
                                   kv_len=kv_len)
    attn_out = shard_hint(attn.reshape(b, n, cfg.q_dim) @ bp["wo"],
                          "batch", "keep", None)
    if cfg.post_norms:
        attn_out = common.rms_norm(attn_out, bp["norm_post_attn"],
                                   cfg.norm_eps)
    h_mid = h + attn_out
    y = common.rms_norm(h_mid, bp["norm2"], cfg.norm_eps)
    ffn_out, aux = apply_ffn_or_moe(bp, y, cfg)
    if cfg.post_norms:
        ffn_out = common.rms_norm(ffn_out, bp["norm_post_ffn"], cfg.norm_eps)
    h_out = h_mid + ffn_out
    entries = None
    if collect_cache:
        entries = {"k": k, "v": v, "h": h_out}
        prox = strat.prefill_proxy(bp, proxy_mat, h, x, attn_out, h_out)
        if prox is not None:
            entries["proxy"] = prox
    return h_out, aux, entries


def _apply_rglru_block(cfg: ModelConfig, bp: Params, h: torch.Tensor,
                       backend) -> torch.Tensor:
    """norm1 -> RG-LRU mixer -> post-attn norm -> residual -> norm2 ->
    FFN -> post-FFN norm -> residual; the scans on ``backend``."""
    x = common.rms_norm(h, bp["norm1"], cfg.norm_eps)
    mix = rglru.apply_rglru(bp["mixer"], x, cfg, backend=backend)
    if cfg.post_norms:
        mix = common.rms_norm(mix, bp["norm_post_attn"], cfg.norm_eps)
    h_mid = h + mix
    y = common.rms_norm(h_mid, bp["norm2"], cfg.norm_eps)
    ffn_out = ffn.apply_ffn(bp["ffn"], y, cfg.act)
    if cfg.post_norms:
        ffn_out = common.rms_norm(ffn_out, bp["norm_post_ffn"],
                                  cfg.norm_eps)
    return h_mid + ffn_out


def _apply_ssd_block(cfg: ModelConfig, bp: Params, h: torch.Tensor,
                     backend) -> torch.Tensor:
    """norm1 -> SSD mixer -> residual (-> norm2 -> FFN -> residual when
    d_ff > 0); the scan on ``backend``."""
    x = common.rms_norm(h, bp["norm1"], cfg.norm_eps)
    h_out = h + ssd.apply_ssd(bp["mixer"], x, cfg, backend=backend)
    if cfg.d_ff > 0:
        y = common.rms_norm(h_out, bp["norm2"], cfg.norm_eps)
        h_out = h_out + ffn.apply_ffn(bp["ffn"], y, cfg.act)
    return h_out


def forward_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor, *,
                   collect_cache: bool = False, spa_proxies=None,
                   strategy=None, kv_len: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Run all blocks.  Returns (h, total aux loss, caches); caches (when
    collect_cache) is {kind: {"k": [Lk,B,N,KVH,HD], ...}} with fresh
    stacked tensors in layer order.  spa_proxies ({kind: [Lk, d, r]}) are
    needed only when collecting with the singular identifier.  With
    ``cfg.remat``, a forward that records gradients recomputes each block
    in the backward pass (``torch.utils.checkpoint``), as the JAX
    ``jax.checkpoint`` per block does."""
    _check_supported(cfg)
    remat = cfg.remat and not collect_cache and h.requires_grad
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    caches: Dict[str, List[Dict[str, torch.Tensor]]] = {}
    for l in range(cfg.n_layers):
        kind = cfg.kind_of_layer(l)
        ki = cfg.kind_index(l)
        bp = layer_params(params, cfg, l)
        pm = (spa_proxies[kind][ki]
              if spa_proxies is not None and kind in spa_proxies else None)
        if remat:
            h, aux = torch.utils.checkpoint.checkpoint(
                _block_remat, cfg, kind, bp, h, strategy, kv_len,
                use_reentrant=False)
            entries = None
        else:
            h, aux, entries = apply_block_dense(
                cfg, kind, bp, h, collect_cache=collect_cache, proxy_mat=pm,
                strategy=strategy, kv_len=kv_len)
        aux_total = aux_total + aux
        if entries is not None:
            caches.setdefault(kind, []).append(entries)
    if not collect_cache:
        return h, aux_total, None
    return h, aux_total, {kind: {name: torch.stack([e[name] for e in lst])
                                 for name in lst[0]}
                          for kind, lst in caches.items()}


def _block_remat(cfg, kind, bp, h, strategy, kv_len):
    h_out, aux, _ = apply_block_dense(cfg, kind, bp, h, strategy=strategy,
                                      kv_len=kv_len)
    return h_out, aux


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    h = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"])
    logits = (h @ table).float()
    if cfg.logit_softcap > 0:
        logits = common.softcap(logits, cfg.logit_softcap)
    return logits
