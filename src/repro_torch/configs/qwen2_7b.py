"""qwen2-7b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [arXiv:2407.10671; hf] GQA, QKV bias
CONFIG = ModelConfig(
        name="qwen2-7b", family="dense", d_model=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6, param_dtype=BF16, compute_dtype=BF16)
