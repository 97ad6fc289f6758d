"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8 routing.

[hf:Qwen/Qwen3-30B-A3B family scaled per assignment] 94L d_model=4096 64H
(GQA kv=4) per-expert d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, MoEConfig, SPAConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    layer_pattern=(ATTN_FULL,),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25, router_aux_weight=0.001),
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=128),
    source="hf:Qwen/Qwen3-30B-A3B",
    zero3=True,
    param_dtype="bfloat16",
    cache_dtype="int8",
    remat=True,
    microbatch=8,
)
