"""dream-7b — the paper's second evaluation model (Dream-v0-Instruct-7B).

[arXiv:2508.15487] Dream 7B: qwen2.5-architecture masked-diffusion LM with
GQA. 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=151936.
SPA hyperparameters from the paper: r=32 (GQA value dim d=512), rho_p=30%
at l_p=14, rho_1=5%, rho_L=25% (Appendix C Table 6).
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="dream-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=151_936,
    layer_pattern=(ATTN_FULL,),
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=32, schedule="adaptive",
                  rho_peak=0.30, rho_first=0.05, rho_last=0.25,
                  layer_peak=14),
    source="arXiv:2508.15487",
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
