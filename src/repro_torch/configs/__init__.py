"""Architecture registry of the port (own copy; imports nothing of ``repro``).

Only the dense all-attention configurations the port runs so far are
registered: the paper's LLaDA-8B and the reduced InternLM2 the tests use.
"""
from repro_torch.configs import internlm2_1_8b, llada_8b
from repro_torch.configs.base import ModelConfig, SPAConfig, reduced

ARCHS = {c.name: c for c in (internlm2_1_8b.CONFIG, llada_8b.CONFIG)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "SPAConfig", "get_arch", "reduced"]
