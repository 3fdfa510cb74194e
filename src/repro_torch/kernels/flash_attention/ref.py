"""Plain PyTorch version of flash attention (``repro.kernels.
flash_attention.ref.attention_ref``): it materializes the score matrix.

Counts its calls in ``attention_ref.launches``: the op runs it for tensors
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counted


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); query head h reads kv head
    h // (Hq // Hkv); query row i sits at global position q_offset + i.
    Computed in fp32, returned in q's dtype."""
    attention_ref.launches += 1
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
        kv_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(q_pos < kv_pos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


counted(attention_ref)
