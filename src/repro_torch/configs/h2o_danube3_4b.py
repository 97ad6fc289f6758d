"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] H2O-Danube series. 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000, SWA.
"""
from repro_torch.configs.base import ATTN_SWA, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32_000,
    layer_pattern=(ATTN_SWA,),
    window=4096,
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=128),
    source="arXiv:2401.16818",
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
