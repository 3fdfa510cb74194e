"""The heap's public ops, routed by the heap's device.

A heap on the card goes to the hand-written kernels (:mod:`.kernel`), and
a launch that is refused raises; a heap on the CPU goes to the plain
versions (:mod:`.ref`).  There is no fallback."""

from __future__ import annotations

import torch

from repro_torch.kernels.shmem_heap.kernel import (shmem_put_cuda,
                                                   shmem_reduce_slots_cuda)
from repro_torch.kernels.shmem_heap.ref import (shmem_put_ref,
                                                shmem_reduce_slots_ref)


def shmem_put(heap, src: torch.Tensor, dst: int, offset: int) -> None:
    """Copy ``src`` (contiguous, on the heap's device) to PE ``dst``'s heap
    at byte ``offset``."""
    if heap.device.type == "cuda":
        shmem_put_cuda(heap, src, dst, offset)
    else:
        shmem_put_ref(heap, src, dst, offset)


def shmem_reduce_slots(heap, offset: int, slot_stride: int, n: int, shape,
                       dtype: torch.dtype, out_dtype: torch.dtype,
                       op: str = "sum") -> torch.Tensor:
    """Sum or max over ``n`` slots of this PE's heap (slot 0 first, fp32
    accumulator), as a new ``out_dtype`` tensor of ``shape``."""
    fn = shmem_reduce_slots_cuda if heap.device.type == "cuda" \
        else shmem_reduce_slots_ref
    return fn(heap, offset, slot_stride, n, shape, dtype, out_dtype, op)
