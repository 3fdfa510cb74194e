"""mamba2-780m — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [arXiv:2405.21060; unverified] SSD (state-space duality); attn-free
CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", d_model=1536, n_layers=48,
    vocab_size=50280, d_inner=3072, ssm_heads=48, ssm_headdim=64,
    ssm_state=128, ssm_groups=1, layer_pattern=(("mamba", "none"),),
    sub_quadratic=True, param_dtype=BF16, compute_dtype=BF16)
