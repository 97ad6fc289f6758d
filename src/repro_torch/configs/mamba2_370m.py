"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060] Mamba-2. 48L d_model=1024, d_ff=0 (no separate FFN;
the SSD block includes the gated expansion), vocab=50280, ssm_state=128.

SPA-Cache applicability: the SSD mixer is a sequence scan — a changed
token perturbs all later chunk states, so sparse row recompute is unsound.
This arch runs WITHOUT the sparse-update technique (identifier="none",
full linear-cost recompute per refinement step).
"""
from repro_torch.configs.base import SSD, ModelConfig, SPAConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,           # = d_inner / ssm head_dim = 2048/64
    n_kv_heads=32,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=(SSD,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    act="silu",
    tie_embeddings=True,
    spa=SPAConfig(identifier="none"),
    source="arXiv:2405.21060",
    tp_weights=False,
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
