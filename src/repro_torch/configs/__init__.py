"""Architecture registry: ``--arch <id>`` resolves here.

The port serves the dense attention, MoE, SSM and hybrid families; the
encoder-decoder and vision-language architectures are known by name and
raise ``NotImplementedError`` naming the slice of the port that brings
them.  qwen2-7b (15.2 GB of bf16 weights) and stablelm-12b (24.3 GB, head
size 160) fit one card at full width.  Of the MoE configs only
qwen3-moe-235b-a22b fits one card at full width, and only with its depth
cut (chip_smoke.py serves 8 of its 94 layers); kimi-k2 and jamba serve at
their ``reduced()`` configs.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (jamba_1_5_large_398b, kimi_k2_1t_a32b,
                                mamba2_780m, qwen2_0_5b, qwen2_7b,
                                qwen3_0_6b, qwen3_moe_235b_a22b,
                                stablelm_12b)
from repro_torch.configs.registry import reduced
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_moe_235b_a22b, kimi_k2_1t_a32b, jamba_1_5_large_398b,
              qwen3_0_6b, qwen2_0_5b, mamba2_780m, qwen2_7b, stablelm_12b)
}

# assigned architectures whose families the port does not serve yet
LATER: Dict[str, str] = {
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
