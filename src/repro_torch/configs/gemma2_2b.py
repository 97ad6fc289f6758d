"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118] Gemma 2 technical report. 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000, sliding window 4096 on local layers, attention
softcap 50.0, final logit softcap 30.0.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ModelConfig,
                                SPAConfig)

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2408.00118",
    post_norms=True,
    embed_scale=True,
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
