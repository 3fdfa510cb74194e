"""Public grouped-GEMM op, routed by device.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), or the call
raises; a CPU tensor goes to the plain version (:mod:`.ref`).  There is no
backend string and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_mm.kernel import grouped_mm_cuda
from repro_torch.kernels.grouped_mm.ref import grouped_mm_ref


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """Rows ``offsets[e]:offsets[e + 1]`` of x (M, K) times w[e] (K, N),
    for each of w's E experts, with an fp32 accumulator rounded once to x's
    dtype; offsets (E + 1,) int32, non-decreasing.  Rows outside
    ``[offsets[0], offsets[E])`` are zero.  The counterpart of
    ``lax.ragged_dot(x, w, group_sizes)`` with ``offsets`` the exclusive
    cumulative sum of ``group_sizes``."""
    if x.device.type == "cpu":
        return grouped_mm_ref(x, w, offsets)
    if x.is_cuda:
        return grouped_mm_cuda(x, w, offsets)
    raise ValueError(f"grouped_mm: unsupported device {x.device}")
