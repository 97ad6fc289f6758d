"""deepseek-67b [dense] — llama-architecture dense model.

[arXiv:2401.02954] DeepSeek LLM. 95L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    layer_pattern=(ATTN_FULL,),
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2401.02954",
    zero3=True,
    param_dtype="bfloat16",
    cache_dtype="int8",   # H/KV caches are TB-scale at 32k x 128 otherwise
    remat=True,
    microbatch=1,
)
