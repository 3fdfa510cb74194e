"""Plain PyTorch versions of the grouped GEMM: the function of
``lax.ragged_dot(x, w, group_sizes)`` with the groups given as offsets,
and of that product followed by the MoE block's silu x up.

A loop over the experts with the offsets read on the host, one
``torch.matmul`` in fp32 per non-empty expert, rounded once to x's dtype.
The ops run them for tensors on the CPU (the tests, the CPU engine); the
card's main path never does: they read the offsets back, which a CUDA
graph capture refuses.  Each counts its calls in its ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import counted


def _grouped(x: torch.Tensor, w: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    M = x.shape[0]
    E, _, N = w.shape
    out = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    off = [min(max(int(o), 0), M) for o in offsets.tolist()]
    for e in range(E):
        lo, hi = off[e], max(off[e + 1], off[e])
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


counted(grouped_mm_ref)
counted(grouped_mm_swiglu_ref)
