"""Public grouped-GEMM ops, routed by device.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), or the call
raises; a CPU tensor goes to the plain version (:mod:`.ref`).  There is no
backend string and no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_mm.kernel import (grouped_mm_cuda,
                                                   grouped_mm_swiglu_cuda)
from repro_torch.kernels.grouped_mm.ref import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)


def _routed(name, cuda, ref, x, w, offsets):
    if x.device.type == "cpu":
        return ref(x, w, offsets)
    if x.is_cuda:
        return cuda(x, w, offsets)
    raise ValueError(f"{name}: unsupported device {x.device}")


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """Rows ``offsets[e]:offsets[e + 1]`` of x (M, K) times w[e] (K, N),
    for each of w's E experts, with an fp32 accumulator rounded once to x's
    dtype; offsets (E + 1,) int32, non-decreasing.  Rows outside
    ``[offsets[0], offsets[E])`` are zero.  The counterpart of
    ``lax.ragged_dot(x, w, group_sizes)`` with ``offsets`` the exclusive
    cumulative sum of ``group_sizes``."""
    return _routed("grouped_mm", grouped_mm_cuda, grouped_mm_ref, x, w,
                   offsets)


def grouped_mm_swiglu(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """``grouped_mm(x, w, offsets)`` = h (M, 2F), w's columns gate | up,
    followed by ``silu(h[:, :F])`` (in fp32, rounded to x's dtype) times
    ``h[:, F:]``: (M, F), rows of no expert zero.  On the card one launch
    computes it without writing h."""
    return _routed("grouped_mm_swiglu", grouped_mm_swiglu_cuda,
                   grouped_mm_swiglu_ref, x, w, offsets)
