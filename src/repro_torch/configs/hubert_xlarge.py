"""hubert-xlarge [audio] — encoder-only transformer (wav2vec2 arch).

[arXiv:2106.07447] HuBERT. 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 (cluster codebook). The conv/mel frontend is stubbed per the
carve-out; input_specs() provides precomputed frame embeddings.
Encoder-only: no decode step (decode shapes skipped, see DESIGN.md).
"""
from repro_torch.configs.base import ATTN_FULL, ModelConfig, SPAConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=(ATTN_FULL,),
    act="gelu_plain",
    tie_embeddings=False,
    is_encoder_only=True,
    frontend="audio",
    spa=SPAConfig(identifier="singular", rank=64),
    source="arXiv:2106.07447",
    max_position=32_768,
    param_dtype="bfloat16",
    remat=True,
    microbatch=1,
)
