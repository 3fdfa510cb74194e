"""qwen3-moe-235b-a22b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [hf:Qwen/Qwen3-30B-A3B; hf] — scaled per assignment row
CONFIG = ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", d_model=4096, n_layers=94,
        n_heads=64, n_kv_heads=4, d_ff=0, d_ff_expert=1536,
        vocab_size=151936, n_experts=128, top_k=8, qk_norm=True,
        rope_theta=1e6, param_dtype=BF16, compute_dtype=BF16)
