"""kimi-k2-1t-a32b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [arXiv:2501.kimi2; unverified] (assignment gives GQA kv=8, not MLA)
CONFIG = ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", d_model=7168, n_layers=61,
        n_heads=64, n_kv_heads=8, d_ff=0, d_ff_expert=2048,
        vocab_size=163840, n_experts=384, top_k=8, rope_theta=1e6,
        param_dtype=BF16, compute_dtype=BF16)
