"""Architecture registry of the port (own copy; imports nothing of ``repro``).

The configurations the port runs so far: the paper's LLaDA-8B, the
reduced InternLM2 the tests use, and the RecurrentGemma-9B hybrid (RG-LRU
and local-attention layers).
"""
from repro_torch.configs import internlm2_1_8b, llada_8b, recurrentgemma_9b
from repro_torch.configs.base import ModelConfig, SPAConfig, reduced

ARCHS = {c.name: c for c in (internlm2_1_8b.CONFIG, llada_8b.CONFIG,
                             recurrentgemma_9b.CONFIG)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "SPAConfig", "get_arch", "reduced"]
