"""pixtral-12b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [hf:mistralai/Pixtral-12B-2409; unverified] pixtral-ViT frontend stubbed:
# the batch provides precomputed patch embeddings at d_model.
CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", d_model=5120, n_layers=40,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    vis_patches=1024, rope_theta=1e6, param_dtype=BF16,
    compute_dtype=BF16)
