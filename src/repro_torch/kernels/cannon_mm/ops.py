"""Public matmul op of the cannon_mm family, routed by device, with a
gradient.

``blocked_matmul`` sends a CUDA tensor to the hand-written kernel
(:mod:`.kernel`), or the call raises; a CPU tensor goes to the plain
version (:mod:`.ref`).  There is no backend string and no fallback.  The
TPU op's ``block_m/n/k`` are VMEM tile sizes and are not carried over (the
CUDA kernel's tiles are its own), nor is its fallback to the reference on
ragged shapes: the kernel masks its edge tiles.

The op is a ``torch.autograd.Function`` whose backward runs the same
routed product on transposed views, ``dA = dC @ B^T`` and
``dB = A^T @ dC``: the kernel reads a transpose through swapped strides,
so nothing is copied for fp32 operands.  With bf16 operands the fp32
cotangent meets a bf16 operand; it is multiplied in fp32 (the bf16 operand
widened exactly) and the gradient rounded to the operand's dtype, as JAX's
transpose of a mixed-precision ``dot_general`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
from repro_torch.kernels.cannon_mm.ref import matmul_ref


def _routed(a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.is_cuda:
        return matmul_cuda(a, b, out_dtype=out_dtype)
    raise ValueError(f"blocked_matmul: unsupported devices {a.device}, "
                     f"{b.device}")


def _same_dtype(x: torch.Tensor, y: torch.Tensor):
    """Both as they are when their dtypes agree, else both widened to fp32
    (exact for bf16)."""
    return (x, y) if x.dtype == y.dtype else (x.float(), y.float())


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _routed(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _routed(*_same_dtype(g, b.transpose(-1, -2)), a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _routed(*_same_dtype(a.transpose(-1, -2), g), b.dtype)
        return ga, gb, None


def blocked_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` with an fp32 accumulator, cast to ``out_dtype`` (a's dtype
    when None).  a (M, K) @ b (K, N), or PE stacks (P, M, K) @ (P, K, N) in
    one launch; float32 or bfloat16; any strides.  Differentiable."""
    return _Matmul.apply(a, b, out_dtype or a.dtype)
