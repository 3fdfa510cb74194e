"""Plain PyTorch versions of the heap's kernels, and the heap on the CPU.

:class:`CpuHeap` is one PE's symmetric heap in host shared memory: a file
of ``nbytes`` in the grid's working directory, mapped shared
(``torch.from_file``), which every peer maps too.  Its ``views`` are the
``uint8`` tensors of every PE's heap, as :class:`.kernel.CudaHeap`'s are on
the card, so the plain versions below run on either heap: they are what the
CPU grid runs, and what ``chip_smoke.py`` holds the kernels against.

:func:`shmem_put_ref` copies the block's bytes into the destination's
view.  :func:`shmem_reduce_slots_ref` adds (or takes the max of) the slots
in slot order with an fp32 accumulator and casts once, which is exactly the
kernel's arithmetic, so the two agree bit for bit.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

from repro_torch.kernels import counted


class CpuHeap:
    """One PE's symmetric heap of ``nbytes`` as a shared file mapping in
    ``workdir``; ``handle`` (the file's name) is what it publishes."""

    def __init__(self, pe: int, n_pes: int, nbytes: int, workdir: str):
        self.pe, self.n_pes, self.nbytes = pe, n_pes, int(nbytes)
        self.device = torch.device("cpu")
        self.workdir = workdir
        self.handle = f"heap_pe{pe}".encode()
        path = os.path.join(workdir, self.handle.decode())
        with open(path, "wb") as f:          # zeroed, as the card's heap
            f.truncate(self.nbytes)
        self.own = torch.from_file(path, shared=True, size=self.nbytes,
                                   dtype=torch.uint8)
        self.views: List[torch.Tensor] = []

    def open_peers(self, handles: Sequence[bytes]) -> None:
        views = []
        for k, h in enumerate(handles):
            if k == self.pe:
                views.append(self.own)
                continue
            views.append(torch.from_file(
                os.path.join(self.workdir, h.decode()), shared=True,
                size=self.nbytes, dtype=torch.uint8))
        self.views = views

    def close_peers(self) -> None:
        self.views = []

    def free(self) -> None:
        self.own = None


def shmem_put_ref(heap, src: torch.Tensor, dst: int, offset: int) -> None:
    """``shmem_put`` of ``src``'s bytes to PE ``dst``'s heap at ``offset``."""
    raw = src.detach().contiguous().reshape(-1).view(torch.uint8)
    heap.views[dst][offset:offset + raw.numel()].copy_(raw)
    shmem_put_ref.launches += 1


def slot(view: torch.Tensor, offset: int, shape, dtype: torch.dtype
         ) -> torch.Tensor:
    """The ``shape`` tensor of ``dtype`` stored at byte ``offset`` of a
    heap view (a view, not a copy)."""
    n = 1
    for d in shape:
        n *= d
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    return view[offset:offset + nbytes].view(dtype).reshape(shape)


def shmem_reduce_slots_ref(heap, offset: int, slot_stride: int, n: int,
                           shape, dtype: torch.dtype,
                           out_dtype: torch.dtype, op: str = "sum"
                           ) -> torch.Tensor:
    """Sum or max over the ``n`` slots of this PE's heap, slot 0 first, in
    fp32; a new ``out_dtype`` tensor of ``shape``."""
    own = heap.views[heap.pe]
    acc = slot(own, offset, shape, dtype).to(torch.float32, copy=True)
    for k in range(1, n):
        v = slot(own, offset + k * slot_stride, shape, dtype).float()
        acc = torch.maximum(acc, v) if op == "max" else acc + v
    shmem_reduce_slots_ref.launches += 1
    return acc.to(out_dtype)


counted(shmem_put_ref)
counted(shmem_reduce_slots_ref)
