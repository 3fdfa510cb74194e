"""Architecture registry: ``--arch <id>`` resolves here.

Every assigned architecture is ported: the dense attention, MoE, SSM and
hybrid families, whisper-base (encoder-decoder: trained, and served
through the fixed-batch decode path of ``serve/decode.py`` with its
encoder's cross-K/V cache; the continuous-batching engine refuses it, as
the JAX engine does) and pixtral-12b (vision-language: trained with
projected patch embeddings, its text served by the engine or the
fixed-batch path).  qwen2-7b (15.2 GB of bf16 weights), stablelm-12b (24.3
GB, head size 160) and pixtral-12b (25.6 GB, head size 160) fit one card at
full width.  Of the MoE configs only qwen3-moe-235b-a22b fits one card at
full width, and only with its depth cut (chip_smoke.py serves 8 of its 94
layers); kimi-k2 and jamba serve at their ``reduced()`` configs.
``LATER`` names architectures whose slice of the port is still to come
(none now); :func:`get_config` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (jamba_1_5_large_398b, kimi_k2_1t_a32b,
                                mamba2_780m, pixtral_12b, qwen2_0_5b,
                                qwen2_7b, qwen3_0_6b, qwen3_moe_235b_a22b,
                                stablelm_12b, whisper_base)
from repro_torch.configs.registry import reduced
from repro_torch.models.config import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_moe_235b_a22b, kimi_k2_1t_a32b, jamba_1_5_large_398b,
              qwen3_0_6b, qwen2_0_5b, mamba2_780m, whisper_base,
              pixtral_12b, qwen2_7b, stablelm_12b)
}

# assigned architectures whose slice of the port is still to come, and
# that slice (empty: every architecture is ported)
LATER: Dict[str, str] = {}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name in LATER:
        raise NotImplementedError(
            f"{name!r} is not ported yet: it comes with {LATER[name]}")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return REGISTRY[name]


__all__ = ["ARCH_NAMES", "LATER", "REGISTRY", "get_config", "reduced"]
