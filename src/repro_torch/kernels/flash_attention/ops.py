"""Public flash-attention op, routed by device.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), or the call
raises; a CPU tensor goes to the plain version (:mod:`.ref`).  There is no
backend string and no fallback.  The TPU op's ``block_q``/``block_kv`` are
VMEM tile sizes and are not carried over (the CUDA kernel's tiles are its
own), nor is its fallback to the reference on ragged shapes: the kernel
masks ragged tails.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Skv, D) with
    GQA (head h reads kv head h // (Hq // Hkv)), causal in global positions
    (query row i at ``q_offset + i``).  Returns q's shape and dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             scale=scale)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
