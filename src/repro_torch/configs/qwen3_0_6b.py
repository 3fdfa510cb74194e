"""qwen3-0.6b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [hf:Qwen/Qwen3-8B; hf] qk_norm, GQA
CONFIG = ModelConfig(
        name="qwen3-0.6b", family="dense", d_model=1024, n_layers=28,
        n_heads=16, n_kv_heads=8, d_ff=3072, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, param_dtype=BF16, compute_dtype=BF16)
