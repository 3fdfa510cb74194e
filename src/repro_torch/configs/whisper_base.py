"""whisper-base — assigned architecture config (see registry docstring)."""

import torch

from repro_torch.models.config import ModelConfig

BF16 = torch.bfloat16

# [arXiv:2212.04356; unverified] enc-dec backbone; conv frontend is a stub
CONFIG = ModelConfig(
        name="whisper-base", family="encdec", d_model=512, n_layers=6,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
        enc_layers=6, enc_seq=1500, norm="layernorm", act="gelu",
        mlp_bias=True, qkv_bias=True, rope_theta=1e4,
        param_dtype=BF16, compute_dtype=BF16)
