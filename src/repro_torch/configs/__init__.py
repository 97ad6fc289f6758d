"""Architecture registry of the port (own copy; imports nothing of ``repro``).

The configurations the port runs: the paper's LLaDA-8B and Dream-7B, the
reduced InternLM2 the tests use, the dense Gemma2-2B (local and global
layers, softcaps, post-norms), H2O-Danube3-4B (sliding window, head_dim
120) and DeepSeek-67B (int8 cache), the RecurrentGemma-9B hybrid (RG-LRU
and local-attention layers), the attention-free Mamba2-370m (SSD), the
MoE Mixtral-8x22B and Qwen3-MoE-235B-A22B, and the stub-frontend
InternVL2-76B (vision patches) and HuBERT-XLarge (audio frames,
encoder-only).
"""
from repro_torch.configs import (deepseek_67b, dream_7b, gemma2_2b,
                                 h2o_danube3_4b, hubert_xlarge,
                                 internlm2_1_8b, internvl2_76b, llada_8b,
                                 mamba2_370m, mixtral_8x22b,
                                 qwen3_moe_235b_a22b, recurrentgemma_9b)
from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      SHAPES, TRAIN_4K, ModelConfig,
                                      MoEConfig, ShapeConfig, SPAConfig,
                                      reduced)

ARCHS = {c.name: c for c in (internlm2_1_8b.CONFIG, llada_8b.CONFIG,
                             dream_7b.CONFIG, gemma2_2b.CONFIG,
                             h2o_danube3_4b.CONFIG, deepseek_67b.CONFIG,
                             recurrentgemma_9b.CONFIG, mamba2_370m.CONFIG,
                             mixtral_8x22b.CONFIG,
                             qwen3_moe_235b_a22b.CONFIG,
                             internvl2_76b.CONFIG, hubert_xlarge.CONFIG)}


# the architectures of the dry run's (arch x shape x mesh) sweep
ASSIGNED = [
    "gemma2-2b", "deepseek-67b", "recurrentgemma-9b", "hubert-xlarge",
    "internlm2-1.8b", "internvl2-76b", "qwen3-moe-235b-a22b", "mamba2-370m",
    "mixtral-8x22b", "h2o-danube-3-4b",
]

# Archs with sub-quadratic sequence mixing (eligible for long_500k).
SUBQUADRATIC = {"recurrentgemma-9b", "mamba2-370m", "mixtral-8x22b",
                "h2o-danube-3-4b"}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is a valid combination."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False  # encoder-only: no decode step
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False  # needs sub-quadratic attention
    return True


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "SUBQUADRATIC", "ModelConfig",
           "MoEConfig", "SPAConfig", "ShapeConfig", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "get_arch",
           "get_shape", "supports_shape", "reduced"]
