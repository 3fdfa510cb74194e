"""Gradient compression for the data-parallel all-reduce, at one worker
(``repro.optim.compress``).

``compressed_allreduce`` runs the JAX package's int8-on-the-wire
all-reduce with error feedback on one worker: the all_to_all and the
all_gather over the data axis are the identity there, but the rest still
happens — the gradient plus the residual block-quantized to int8 (blocks
of 256, fp32 scale ``max|x| / 127 + 1e-12``), dequantized and summed
(one term), re-quantized and dequantized, and the quantization error of
this worker's contribution kept as the next residual.  So
``--grad-compress`` changes the numbers on one card as it does on many.
Every step is block-local: any slice of the flattened gradient made of
whole blocks gives the same bits as the whole.  ``compressed_psum`` takes
the grid's sum as ``psum_fn`` (``PeGrid.psum_all`` on a grid of PE
processes, whose integer sums are exact), as the JAX tests pass
``lax.psum``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

QBLOCK = 256


def _quant(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    flat = x32.reshape(-1)
    pad = (-flat.numel()) % QBLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), flat.numel()


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)


def compressed_allreduce(g: torch.Tensor, residual: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (summed gradient fp32, new residual fp32) at one worker."""
    g32 = g.float() + residual.float()
    q, scale, padded = _quant(g32)
    # phase 1 (int8 all_to_all) is the identity; the exact fp32 sum of the
    # one worker's shard
    shard_sum = q.float() * scale
    # phase 2: re-quantize; the int8 all_gather is the identity
    sq, sscale, _ = _quant(shard_sum)
    n = g32.numel()
    summed = _dequant(sq, sscale)[:padded][:n].reshape(g32.shape)
    mine_on_wire = _dequant(q, scale)[:n].reshape(g32.shape)
    return summed, g32 - mine_on_wire


def compressed_psum(g: torch.Tensor, residual: torch.Tensor,
                    psum_fn: Callable = lambda x: x
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-collective variant: quantize (with the residual), reduce the
    widened codes with ``psum_fn`` (the identity on one worker),
    dequantize with the mean scale, keep the local quantization error."""
    g32 = g.float() + residual
    q, scale, _ = _quant(g32)
    summed = psum_fn(q.to(torch.int32))
    mean_scale = psum_fn(scale) / psum_fn(torch.ones((), dtype=torch.float32,
                                                     device=g.device))
    n = g32.numel()
    out = (summed.float() * mean_scale).reshape(-1)[:n].reshape(g32.shape)
    mine = (q.float() * mean_scale).reshape(-1)[:n].reshape(g32.shape)
    return out, g32 - mine
