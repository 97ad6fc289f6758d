"""internlm2-1.8b [dense] — llama-style GQA model.

[arXiv:2403.17297] InternLM2. 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    layer_pattern=(ATTN_FULL,),
    act="silu",
    tie_embeddings=True,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2403.17297",
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
