"""Plain PyTorch versions of the grouped GEMM: the function of
``lax.ragged_dot(x, w, group_sizes)`` with the groups given as offsets,
of that product followed by the MoE block's silu x up, and of the two
backward products (dgrad, wgrad) that JAX's autodiff of ``ragged_dot``
computes.

A loop over the experts with the offsets read on the host, one
``torch.matmul`` in fp32 per non-empty expert, rounded once to x's dtype.
The ops run them for tensors on the CPU (the tests, the CPU engine); the
card's main path never does: they read the offsets back, which a CUDA
graph capture refuses.  Each counts its calls in its ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import counted


def _ranges(offsets: torch.Tensor, M: int):
    """Each expert's row range ``(lo, hi)``, clamped into [0, M] as the
    kernels clamp them."""
    off = [min(max(int(o), 0), M) for o in offsets.tolist()]
    return [(off[e], max(off[e + 1], off[e])) for e in range(len(off) - 1)]


def _grouped(x: torch.Tensor, w: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    M = x.shape[0]
    out = torch.zeros((M, w.shape[2]), dtype=x.dtype, device=x.device)
    for e, (lo, hi) in enumerate(_ranges(offsets, M)):
        if hi > lo:
            out[lo:hi] = torch.matmul(x[lo:hi].float(),
                                      w[e].float()).to(x.dtype)
    return out


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (E, K, N), offsets (E + 1,) -> (M, N) in x's dtype: rows
    ``offsets[e]:offsets[e + 1]`` times ``w[e]``, rows of no expert zero."""
    grouped_mm_ref.launches += 1
    return _grouped(x, w, offsets)


def grouped_mm_swiglu_ref(x: torch.Tensor, w: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (E, K, 2F) gate | up, offsets (E + 1,) -> (M, F): the
    grouped product h, then ``silu(h[:, :F].float()).to(h.dtype) *
    h[:, F:]`` as ``src/repro/models/moe.py:117-119`` rounds it.  Rows of no
    expert are zero (silu(0) * 0)."""
    grouped_mm_swiglu_ref.launches += 1
    h = _grouped(x, w, offsets)
    F = w.shape[2] // 2
    return torch.nn.functional.silu(h[:, :F].float()).to(h.dtype) * h[:, F:]


def grouped_mm_dgrad_ref(dy: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """dy (M, N), w (E, K, N), offsets (E + 1,) -> dx (M, K) in dy's dtype:
    rows ``offsets[e]:offsets[e + 1]`` of dy times ``w[e]^T`` in fp32,
    rounded once; rows of no expert zero."""
    grouped_mm_dgrad_ref.launches += 1
    M = dy.shape[0]
    dx = torch.zeros((M, w.shape[1]), dtype=dy.dtype, device=dy.device)
    for e, (lo, hi) in enumerate(_ranges(offsets, M)):
        if hi > lo:
            dx[lo:hi] = torch.matmul(dy[lo:hi].float(),
                                     w[e].float().T).to(dy.dtype)
    return dx


def grouped_mm_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """x (M, K), dy (M, N), offsets (E + 1,) -> dw (E, K, N) in x's dtype:
    ``x[rows]^T dy[rows]`` in fp32 per expert, rounded once; zeros for an
    expert with no rows."""
    grouped_mm_wgrad_ref.launches += 1
    M = x.shape[0]
    E = offsets.numel() - 1
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=x.dtype,
                     device=x.device)
    for e, (lo, hi) in enumerate(_ranges(offsets, M)):
        if hi > lo:
            dw[e] = torch.matmul(x[lo:hi].float().T,
                                 dy[lo:hi].float()).to(x.dtype)
    return dw


def swiglu_grad(h: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """The cotangent of h (M, 2F) = gate | up from that of
    ``silu(gate.float()).to(h.dtype) * up`` (M, F), rounded where JAX's
    autodiff of ``src/repro/models/moe.py:118-119`` rounds: the two
    products with the cotangent in h's dtype, silu' in fp32 (``d * sig +
    (d * g) * sig * (1 - sig)``, the transpose of ``x * logistic(x)``),
    then the gate's cotangent rounded to h's dtype.  Torch ops only: the
    card's backward and the plain one both use it."""
    F = h.shape[1] // 2
    g32, u = h[:, :F].float(), h[:, F:]
    sig = torch.sigmoid(g32)
    s = torch.nn.functional.silu(g32).to(h.dtype)
    du = d_out * s
    ds = (d_out * u).float()
    dg = ds * sig + (ds * g32) * (sig * (1.0 - sig))
    return torch.cat([dg.to(h.dtype), du], dim=1)


for _fn in (grouped_mm_ref, grouped_mm_swiglu_ref, grouped_mm_dgrad_ref,
            grouped_mm_wgrad_ref):
    counted(_fn)
