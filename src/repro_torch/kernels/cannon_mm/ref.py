"""Plain PyTorch version of the cannon_mm kernel (``repro.kernels.cannon_mm.
ref.matmul_ref``): upcast to fp32, multiply, cast to ``out_dtype``.

It takes a leading batch too, as the CUDA kernel does, and counts its calls
in ``matmul_ref.launches``: the op runs it for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) in fp32, cast to ``out_dtype`` (a's dtype
    when None)."""
    matmul_ref.launches += 1
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


matmul_ref.launches = 0
