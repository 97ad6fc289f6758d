"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern 1:2.

[arXiv:2402.19427] Griffin/RecurrentGemma. 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000. Pattern: two RG-LRU blocks followed by one local
(sliding-window) attention block.
"""
from repro_torch.configs.base import (ATTN_LOCAL, RGLRU, ModelConfig,
                                      RGLRUConfig, SPAConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    window=2048,
    rglru=RGLRUConfig(d_rnn=4096, conv_width=4, n_heads=16),
    act="gelu",
    tie_embeddings=True,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2402.19427",
    post_norms=True,
    embed_scale=True,
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
