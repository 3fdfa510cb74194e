"""stablelm-12b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [hf:stabilityai/stablelm-2-1_6b; hf]
CONFIG = ModelConfig(
        name="stablelm-12b", family="dense", d_model=5120, n_layers=40,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab_size=100352,
        norm="layernorm", rope_theta=1e4, param_dtype=BF16,
        compute_dtype=BF16)
