"""Architecture registry of the port (own copy; imports nothing of ``repro``).

The configurations the port runs so far: the paper's LLaDA-8B, the
reduced InternLM2 the tests use, the RecurrentGemma-9B hybrid (RG-LRU
and local-attention layers) and the attention-free Mamba2-370m (SSD).
"""
from repro_torch.configs import (internlm2_1_8b, llada_8b, mamba2_370m,
                                 recurrentgemma_9b)
from repro_torch.configs.base import ModelConfig, SPAConfig, reduced

ARCHS = {c.name: c for c in (internlm2_1_8b.CONFIG, llada_8b.CONFIG,
                             recurrentgemma_9b.CONFIG, mamba2_370m.CONFIG)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "SPAConfig", "get_arch", "reduced"]
