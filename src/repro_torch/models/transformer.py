"""Dense masked-diffusion transformer assembled from a ``ModelConfig``.

The port of the JAX package's ``models/transformer.py`` for attention
layer kinds with a dense FFN (LLaDA / InternLM2 shapes), the RG-LRU
hybrid (RecurrentGemma) and the attention-free SSD stack (Mamba2).
Parameters keep the JAX layout: a plain dict with ``embed``,
``final_norm``, ``lm_head`` (when untied) and per-kind STACKED blocks
``blocks[kind][name]`` with a leading ``[L_kind]`` axis, so the JAX
package's weights carry over leaf for leaf (``repro_torch.weights``).
MoE and the stub frontends wait for later slices.  The layer loop is
unrolled, so a hybrid needs no period plan (JAX scans a period only to
compile it as one loop).

Attention and the SSD scan go through the strategy's ``KernelBackend`` (the
CUDA kernels on the card); attention with contiguous query positions, so
prefill and the SPA step share one attention implementation.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTENTION_KINDS, ATTN_LOCAL, ATTN_SWA,
                                      RGLRU, SSD, ModelConfig)
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import common, ffn, rglru, ssd

Params = Dict[str, Any]


def layer_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind in (ATTN_SWA, ATTN_LOCAL) else 0


def _check_supported(cfg: ModelConfig) -> None:
    ported = set(ATTENTION_KINDS) | {RGLRU, SSD}
    kinds = set(cfg.layer_kinds)
    if not kinds <= ported:
        raise NotImplementedError(
            f"layer kinds {sorted(kinds - ported)} wait for a later slice")
    if cfg.moe is not None:
        raise NotImplementedError("MoE blocks wait for a later slice")
    if cfg.frontend is not None or cfg.max_position:
        raise NotImplementedError("stub frontends / learned positions wait "
                                  "for a later slice")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Params:
    """Random weights in ``cfg.param_dtype`` on ``device`` (the card unless
    the caller names another), drawn from one seeded ``torch.Generator``
    tensor by tensor (no f32 copy of the model).  The values differ from
    the JAX package's ``jax.random`` init; carry JAX weights across with
    ``repro_torch.weights.from_numpy_params`` instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    gen = torch.Generator(device=dev)
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
        if cfg.d_ff > 0:
            f = cfg.d_ff
            if cfg.act in ("silu", "gelu"):
                bp["ffn"] = {
                    "w_gate": common.dense_init_(empty(lk, d, f), gen),
                    "w_up": common.dense_init_(empty(lk, d, f), gen),
                    "w_down": common.dense_init_(empty(lk, f, d), gen)}
            else:
                bp["ffn"] = {
                    "w_up": common.dense_init_(empty(lk, d, f), gen),
                    "b_up": zeros(lk, f),
                    "w_down": common.dense_init_(empty(lk, f, d), gen),
                    "b_down": zeros(lk, d)}
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
    """inputs: {"tokens": [B, T]} -> h0 [B, T, d] (token path only)."""
    _check_supported(cfg)
    h = params["embed"][inputs["tokens"].long()]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


# ---------------------------------------------------------------------------
# Block application (dense path)
# ---------------------------------------------------------------------------

def qkv_project(bp: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x: [B,S,d] (already normed) -> q [B,S,H,hd], k/v [B,S,KVH,hd]."""
    b, s, _ = x.shape
    q = (x @ bp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ bp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ bp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_ffn_or_moe(bp: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    if "moe" in bp:
        raise NotImplementedError("MoE blocks wait for a later slice")
    if "ffn" in bp:
        return ffn.apply_ffn(bp["ffn"], x, cfg.act)
    return torch.zeros_like(x)


def apply_block_dense(cfg: ModelConfig, kind: str, bp: Params,
                      h: torch.Tensor, *, collect_cache: bool = False,
                      proxy_mat: Optional[torch.Tensor] = None,
                      strategy=None,
                      kv_len: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor,
                                 Optional[Dict[str, torch.Tensor]]]:
    """One block over the full sequence.  Returns (h_out, cache entries or
    None); an attention block's entries hold the raw k/v/h (+ proxy)
    tensors, a recurrent block keeps no cache."""
    from repro_torch.core.strategy import resolve_strategy
    strat = resolve_strategy(cfg, strategy)
    if kind == RGLRU:
        return _apply_rglru_block(cfg, bp, h, strat.backend), None
    if kind == SSD:
        return _apply_ssd_block(cfg, bp, h, strat.backend), None
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
    attn_out = attn.reshape(b, n, cfg.q_dim) @ bp["wo"]
    if cfg.post_norms:
        attn_out = common.rms_norm(attn_out, bp["norm_post_attn"],
                                   cfg.norm_eps)
    h_mid = h + attn_out
    y = common.rms_norm(h_mid, bp["norm2"], cfg.norm_eps)
    ffn_out = apply_ffn_or_moe(bp, y, cfg)
    if cfg.post_norms:
        ffn_out = common.rms_norm(ffn_out, bp["norm_post_ffn"], cfg.norm_eps)
    h_out = h_mid + ffn_out
    entries = None
    if collect_cache:
        entries = {"k": k, "v": v, "h": h_out}
        prox = strat.prefill_proxy(bp, proxy_mat, h, x, attn_out, h_out)
        if prox is not None:
            entries["proxy"] = prox
    return h_out, entries


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
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Run all blocks.  Returns (h, caches); caches (when collect_cache)
    is {kind: {"k": [Lk,B,N,KVH,HD], ...}} with fresh stacked tensors in
    layer order.  spa_proxies ({kind: [Lk, d, r]}) are needed only when
    collecting with the singular identifier."""
    _check_supported(cfg)
    caches: Dict[str, List[Dict[str, torch.Tensor]]] = {}
    for l in range(cfg.n_layers):
        kind = cfg.kind_of_layer(l)
        ki = cfg.kind_index(l)
        bp = layer_params(params, cfg, l)
        pm = (spa_proxies[kind][ki]
              if spa_proxies is not None and kind in spa_proxies else None)
        h, entries = apply_block_dense(cfg, kind, bp, h,
                                       collect_cache=collect_cache,
                                       proxy_mat=pm, strategy=strategy,
                                       kv_len=kv_len)
        if entries is not None:
            caches.setdefault(kind, []).append(entries)
    if not collect_cache:
        return h, None
    return h, {kind: {name: torch.stack([e[name] for e in lst])
                      for name in lst[0]}
               for kind, lst in caches.items()}


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    h = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = (params["embed"].T if cfg.tie_embeddings
             else params["lm_head"])
    logits = (h @ table).float()
    if cfg.logit_softcap > 0:
        logits = common.softcap(logits, cfg.logit_softcap)
    return logits
