"""Reduced (smoke-test) config derivation.

The full configs live one-per-module in this package (see __init__); this
module derives the CPU smoke sibling: same family, same layer topology and
code paths, tiny dims.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test sibling: same family, topology and code paths, tiny dims."""
    plen = len(cfg.pattern())
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=64, n_layers=max(plen, 2 if plen == 1 else plen),
        vocab_size=256,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_block_kv=64,
    )
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4) or 2,
                  head_dim=8)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.n_experts:
        kw.update(n_experts=16, top_k=min(cfg.top_k, 2), d_ff_expert=32,
                  capacity_factor=2.0)
    if cfg.d_inner:
        kw.update(d_inner=128, ssm_heads=8, ssm_headdim=16,
                  ssm_state=16, ssm_groups=min(cfg.ssm_groups, 4),
                  ssd_chunk=32)
    if cfg.enc_layers:
        kw.update(enc_layers=2, n_layers=2, enc_seq=32)
    if cfg.vis_patches:
        kw.update(vis_patches=16)
    return dataclasses.replace(cfg, **kw)
