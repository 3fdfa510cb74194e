"""Architecture registry: ``--arch <id>`` resolves here.

The port serves the dense attention and SSM families; every other assigned
architecture is known by name and raises ``NotImplementedError`` naming the
slice of the port that brings it.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import mamba2_780m, qwen2_0_5b, qwen3_0_6b
from repro_torch.configs.registry import reduced
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_0_6b, qwen2_0_5b, mamba2_780m)
}

# assigned architectures whose families the port does not serve yet
LATER: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "the MoE slice",
    "kimi-k2-1t-a32b": "the MoE slice",
    "jamba-1.5-large-398b": "the MoE slice",
    "stablelm-12b": "a later dense-config slice",
    "qwen2-7b": "a later dense-config slice",
    "whisper-base": "the encoder-decoder slice",
    "pixtral-12b": "the vision-language slice",
}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name in LATER:
        raise NotImplementedError(
            f"{name!r} is not ported yet: it comes with {LATER[name]}")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return REGISTRY[name]


__all__ = ["ARCH_NAMES", "LATER", "REGISTRY", "get_config", "reduced"]
