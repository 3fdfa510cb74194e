"""jamba-1.5-large-398b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

_JAMBA_PATTERN = tuple(
    (("attn" if l == 0 else "mamba"), ("moe" if l % 2 == 1 else "mlp"))
    for l in range(8))

# [arXiv:2403.19887; hf] Mamba+attn 1:7, MoE 16e top-2 every 2nd layer
CONFIG = ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", d_model=8192,
        n_layers=72, n_heads=64, n_kv_heads=8, d_ff=24576, d_ff_expert=24576,
        vocab_size=65536, n_experts=16, top_k=2,
        d_inner=16384, ssm_heads=128, ssm_headdim=128, ssm_state=16,
        ssm_groups=8, layer_pattern=_JAMBA_PATTERN, rope_theta=1e6,
        sub_quadratic=True, param_dtype=BF16, compute_dtype=BF16)
