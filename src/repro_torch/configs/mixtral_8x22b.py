"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] Mixtral of Experts (8x22B variant per assignment).
56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768, SWA.
"""
from repro_torch.configs.base import ATTN_SWA, ModelConfig, MoEConfig, SPAConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    layer_pattern=(ATTN_SWA,),
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25, router_aux_weight=0.01),
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2401.04088",
    zero3=True,
    param_dtype="bfloat16",
    cache_dtype="int8",
    remat=True,
    microbatch=8,
)
