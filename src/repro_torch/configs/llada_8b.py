"""llada-8b — the paper's primary evaluation model (LLaDA-8B-Instruct).

[arXiv:2502.09992] LLaDA: llama-architecture masked-diffusion LM.
32L d_model=4096 32H (MHA) d_ff=12288 vocab=126464.
SPA hyperparameters from the paper: r=128, rho_p=25% at l_p=24,
rho_1=3%, rho_L=13% (Appendix C Table 6).
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="llada-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=12288,
    vocab_size=126_464,
    layer_pattern=(ATTN_FULL,),
    act="silu",
    tie_embeddings=False,
    spa=SPAConfig(identifier="singular", rank=128, schedule="adaptive",
                  rho_peak=0.25, rho_first=0.03, rho_last=0.13,
                  layer_peak=24),
    source="arXiv:2502.09992",
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
