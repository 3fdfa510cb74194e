"""Public grouped-GEMM ops, routed by device, with a gradient.

A CUDA tensor goes to the hand-written kernels (:mod:`.kernel`), or the
call raises; a CPU tensor goes to the plain versions (:mod:`.ref`).  A
meta tensor (the dry run, ``launch/dryrun.py``) takes the meta route: an
empty meta tensor of the kernel's output shape and dtype, the launch's
work added to the open counts of :mod:`.cost`; it computes nothing and
stands in for the kernel's launch, not for a result.  There is no backend
string and no fallback.

Both ops are ``torch.autograd.Function`` subclasses.  The backward of
``grouped_mm`` is dgrad (``dy w[e]^T`` per expert) and wgrad
(``x[rows]^T dy[rows]`` per expert), the two products JAX's autodiff of
``lax.ragged_dot`` computes; that of ``grouped_mm_swiglu`` first
recomputes the product h (M, 2F) with the forward kernel, rather than
keeping it from the forward (the step's remat keeps activations out of
memory the same way), forms the cotangent of gate | up in torch
(:func:`.ref.swiglu_grad`), then runs dgrad and wgrad.  The offsets get no
gradient.  On the card the forward and backward kernels refuse to be
called directly with inputs that require grad; these functions are how
training reaches them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_mm import cost
from repro_torch.kernels.grouped_mm.kernel import (grouped_mm_cuda,
                                                   grouped_mm_dgrad_cuda,
                                                   grouped_mm_swiglu_cuda,
                                                   grouped_mm_wgrad_cuda)
from repro_torch.kernels.grouped_mm.ref import (grouped_mm_dgrad_ref,
                                                grouped_mm_ref,
                                                grouped_mm_swiglu_ref,
                                                grouped_mm_wgrad_ref,
                                                swiglu_grad)


def _meta(kind, a, b, offsets):
    """The meta route of one launch of ``kind`` (:data:`.cost.KINDS`):
    the wrapper's allocations on the meta device (its output, and wgrad's
    tile counter on bf16), and the launch recorded at every row of
    ``a``."""
    M = a.shape[0]
    if kind == "wgrad":                     # a = x (M, K), b = dy (M, N)
        E, K, N = offsets.numel() - 1, a.shape[1], b.shape[1]
        shape = (E, K, N)
    elif kind == "dgrad":                   # a = dy (M, N), b = w (E, K, N)
        E, K, N = b.shape
        shape = (M, K)
    else:                                   # a = x (M, K), b = w (E, K, N)
        E, K, N = b.shape
        shape = (M, N // 2 if kind == "swiglu" else N)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if kind == "wgrad" and a.dtype == torch.bfloat16:
        torch.empty(1, dtype=torch.int32, device=a.device)   # the counter
    cost.record(kind, M, K, N, E, min(E, M), a.element_size())
    return out


def _routed(name, kind, cuda, ref, a, *args):
    if a.device.type == "cpu":
        return ref(a, *args)
    if a.is_cuda:
        return cuda(a, *args)
    if a.is_meta:
        return _meta(kind, a, *args)
    raise ValueError(f"{name}: unsupported device {a.device}")


def _forward(x, w, offsets):
    return _routed("grouped_mm", "forward", grouped_mm_cuda, grouped_mm_ref,
                   x, w, offsets)


def _backward(ctx, x, w, offsets, dy):
    """(dx, dw) of the product x (M, K) by w (E, K, N) for cotangent dy."""
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = _routed("grouped_mm dgrad", "dgrad", grouped_mm_dgrad_cuda,
                     grouped_mm_dgrad_ref, dy, w, offsets)
    if ctx.needs_input_grad[1]:
        dw = _routed("grouped_mm wgrad", "wgrad", grouped_mm_wgrad_cuda,
                     grouped_mm_wgrad_ref, x, dy, offsets)
    return dx, dw, None


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return _forward(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        return _backward(ctx, x, w, offsets, dy.contiguous())


class _GroupedMMSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return _routed("grouped_mm_swiglu", "swiglu", grouped_mm_swiglu_cuda,
                       grouped_mm_swiglu_ref, x, w, offsets)

    @staticmethod
    def backward(ctx, d_out):
        x, w, offsets = ctx.saved_tensors
        dh = swiglu_grad(_forward(x, w, offsets), d_out)
        return _backward(ctx, x, w, offsets, dh)


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """Rows ``offsets[e]:offsets[e + 1]`` of x (M, K) times w[e] (K, N),
    for each of w's E experts, with an fp32 accumulator rounded once to x's
    dtype; offsets (E + 1,) int32, non-decreasing.  Rows outside
    ``[offsets[0], offsets[E])`` are zero.  The counterpart of
    ``lax.ragged_dot(x, w, group_sizes)`` with ``offsets`` the exclusive
    cumulative sum of ``group_sizes``.  Differentiable in x and w."""
    return _GroupedMM.apply(x, w, offsets)


def grouped_mm_swiglu(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """``grouped_mm(x, w, offsets)`` = h (M, 2F), w's columns gate | up,
    followed by ``silu(h[:, :F])`` (in fp32, rounded to x's dtype) times
    ``h[:, F:]``: (M, F), rows of no expert zero.  On the card one launch
    computes it without writing h.  Differentiable in x and w."""
    return _GroupedMMSwiglu.apply(x, w, offsets)
