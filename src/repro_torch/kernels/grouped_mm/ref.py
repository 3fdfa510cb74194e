"""Plain PyTorch version of the grouped GEMM: the function of
``lax.ragged_dot(x, w, group_sizes)`` with the groups given as offsets.

A loop over the experts with the offsets read on the host, one
``torch.matmul`` in fp32 per non-empty expert, rounded once to x's dtype.
The op runs it for tensors on the CPU (the tests, the CPU engine); the
card's main path never does: it reads the offsets back, which a CUDA graph
capture refuses.  It counts its calls in ``grouped_mm_ref.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import counted


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (E, K, N), offsets (E + 1,) -> (M, N) in x's dtype: rows
    ``offsets[e]:offsets[e + 1]`` times ``w[e]``, rows of no expert zero."""
    grouped_mm_ref.launches += 1
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


counted(grouped_mm_ref)
