"""qwen2-0.5b — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [arXiv:2407.10671; hf] GQA kv=2, QKV bias
CONFIG = ModelConfig(
        name="qwen2-0.5b", family="dense", d_model=896, n_layers=24,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6, param_dtype=BF16, compute_dtype=BF16)
