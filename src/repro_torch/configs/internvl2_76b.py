"""internvl2-76b [vlm] — InternViT + InternLM2/Llama3-70B backbone.

[arXiv:2404.16821] InternVL 1.5/2. Language backbone: 80L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256. The InternViT vision encoder +
MLP projector are stubbed per the carve-out; input_specs() supplies
pre-projected patch embeddings interleaved with text embeddings.
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    layer_pattern=(ATTN_FULL,),
    act="silu",
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=1024,   # stub image-patch tokens prepended
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2404.16821",
    zero3=True,
    param_dtype="bfloat16",
    cache_dtype="int8",
    remat=True,
    microbatch=1,
)
