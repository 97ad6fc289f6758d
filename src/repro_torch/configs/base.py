"""Configuration dataclasses for the SPA-Cache framework (PyTorch port).

Every architecture in the assigned pool is expressed as a ``ModelConfig``;
the paper's technique is configured via ``SPAConfig`` and the canonical
input shapes via ``ShapeConfig``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Layer kinds understood by the transformer assembler.
ATTN_FULL = "attn"          # full bidirectional GQA attention
ATTN_SWA = "swa"            # sliding-window attention
ATTN_LOCAL = "local"        # gemma2-style local (sliding window) layer
ATTN_GLOBAL = "global"      # gemma2-style global (full) layer
RGLRU = "rglru"             # RecurrentGemma gated linear recurrence block
SSD = "ssd"                 # Mamba2 state-space duality mixer

ATTENTION_KINDS = (ATTN_FULL, ATTN_SWA, ATTN_LOCAL, ATTN_GLOBAL)
RECURRENT_KINDS = (RGLRU, SSD)


@dataclasses.dataclass(frozen=True)
class SPAConfig:
    """Configuration of the paper's caching technique (Algorithm 1).

    identifier:
      none      — vanilla decoding, no cache (paper's BASELINE row)
      value     — full d-dim Value-state proxy (dLLM-Cache, Liu et al. 2025b)
      singular  — the paper's rank-r singular proxy (Sec. 3.3)
      query/key/attn_in/attn_out — Table-1 ablation identifiers
      window    — dKV-Cache style locality heuristic (Ma et al. 2025)
    schedule:
      uniform   — fixed rho across layers (prior work)
      adaptive  — piecewise-Gaussian rho(l) of Eq. (5)
    """

    identifier: str = "singular"
    rank: int = 128
    schedule: str = "adaptive"
    rho_peak: float = 0.25          # rho_p
    rho_first: float = 0.03         # rho_1
    rho_last: float = 0.13          # rho_L
    layer_peak: Optional[int] = None  # l_p (1-indexed); None -> ceil(0.6 * L)
    n_buckets: int = 6              # contiguous-layer budget buckets (JAX layer scan)
    refresh_interval: int = 0       # full refresh every k steps (0 = never)
    locality_window: int = 64       # for identifier == "window"
    incremental_ident: bool = False  # beyond-paper: recompute proxies only
                                     # for rows whose inputs changed

    def resolved_layer_peak(self, n_layers: int) -> int:
        if self.layer_peak is not None:
            return self.layer_peak
        return max(1, math.ceil(0.6 * n_layers))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    n_shared_experts: int = 0
    d_ff_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD mixer parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block parameters."""

    d_rnn: Optional[int] = None      # None -> d_model
    conv_width: int = 4
    n_heads: int = 0                 # block-diagonal gate heads; 0 -> dense gates


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = (ATTN_FULL,)
    window: int = 4096              # sliding window for swa/local layers
    logit_softcap: float = 0.0      # gemma2 final-logit softcap
    attn_softcap: float = 0.0       # gemma2 attention-logit softcap
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    spa: SPAConfig = dataclasses.field(default_factory=SPAConfig)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (gated) | gelu (gated) | gelu_plain
    tie_embeddings: bool = True
    is_encoder_only: bool = False   # hubert: no decode step
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_tokens: int = 0        # number of stub modality tokens prepended
    mask_token_id: int = 0          # DLM [MASK]; resolved at init to vocab-1
    source: str = ""                # citation for the config
    post_norms: bool = False        # gemma-style post-attn/post-ffn norms
    embed_scale: bool = False       # gemma-style sqrt(d) embedding scale
    max_position: int = 0           # >0: learned abs positions (encoder-only)
    zero3: bool = False             # shard params over data axis too
    tp_weights: bool = True         # False: replicate all weights (small
                                    # models; kills TP collectives)
    accum_dtype: str = "float32"    # grad-accumulation/AR dtype
    accum_unroll: bool = False      # python-loop microbatches (lets XLA
                                    # CSE ZeRO-3 weight gathers across them)
    # -- numerics / execution --
    param_dtype: str = "float32"
    cache_dtype: str = "float32"    # "int8" enables quantized caches
    remat: bool = False
    microbatch: int = 0             # grad-accum microbatches (0 = off)
    scan_layers: bool = True        # scan over layer stacks when homogeneous

    def kind_of_layer(self, l: int) -> str:
        return self.layer_pattern[l % len(self.layer_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.kind_of_layer(l) for l in range(self.n_layers))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def kind_index(self, l: int) -> int:
        """Index of layer ``l`` within the stack of its own kind."""
        kind = self.kind_of_layer(l)
        return sum(1 for j in range(l) if self.kind_of_layer(j) == kind)

    def n_layers_of_kind(self, kind: str) -> int:
        return sum(1 for k in self.layer_kinds if k == kind)

    @property
    def mask_id(self) -> int:
        return self.vocab_size - 1 if self.mask_token_id == 0 else self.mask_token_id

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for l in range(L):
            kind = self.kind_of_layer(l)
            if kind in ATTENTION_KINDS:
                total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                total += self._ffn_params()
            elif kind == RGLRU:
                dr = (self.rglru.d_rnn or d) if self.rglru else d
                total += 2 * d * dr + dr * d + 3 * dr  # in/out proj + gates
                total += self._ffn_params()
            elif kind == SSD:
                ssm = self.ssm or SSMConfig()
                di = ssm.d_inner(d)
                nh = ssm.n_heads(d)
                total += d * (2 * di + 2 * ssm.d_state + nh) + di * d
                if self.d_ff > 0:
                    total += self._ffn_params()
            total += 2 * d  # norms
        return total

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            per = 3 * d * m.d_ff_expert
            total = m.n_experts * per + d * m.n_experts  # experts + router
            if m.n_shared_experts:
                total += m.n_shared_experts * 3 * d * m.d_ff_shared
            return total
        if self.d_ff == 0:
            return 0
        mult = 3 if self.act in ("silu", "gelu") else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Active params per token (= dense count for non-MoE)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        dense = self.param_count()
        moe_layers = sum(
            1 for l in range(self.n_layers)
            if self.kind_of_layer(l) in ATTENTION_KINDS
        )
        all_experts = moe_layers * m.n_experts * 3 * d * m.d_ff_expert
        active_experts = moe_layers * m.top_k * 3 * d * m.d_ff_expert
        return dense - all_experts + active_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family variant of ``cfg`` for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        window=min(cfg.window, 64),
        microbatch=0,
        remat=False,
        param_dtype="float32",
        cache_dtype="float32",
        frontend_tokens=min(cfg.frontend_tokens, 16),
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            d_ff_shared=min(cfg.moe.d_ff_shared, 128),
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=16)
    if cfg.rglru is not None:
        small["rglru"] = dataclasses.replace(
            cfg.rglru, d_rnn=None, n_heads=min(cfg.rglru.n_heads or 4, 4))
    if cfg.spa is not None:
        small["spa"] = dataclasses.replace(cfg.spa, rank=16)
    small.update(overrides)
    # Keep pattern but clip peak layer.
    out = dataclasses.replace(cfg, **small)
    if out.spa.layer_peak is not None and out.spa.layer_peak > out.n_layers:
        out = dataclasses.replace(
            out, spa=dataclasses.replace(out.spa, layer_peak=None))
    return out
