"""The symmetric heap of a grid of PE processes and its two kernels, put
and reduce_slots: the port's counterparts of XLA's collective-permute and
grouped all-reduce, which carry the JAX package's ``ShmemGrid``."""

from repro_torch.kernels.shmem_heap.kernel import CudaHeap
from repro_torch.kernels.shmem_heap.ops import shmem_put, shmem_reduce_slots
from repro_torch.kernels.shmem_heap.ref import (CpuHeap, shmem_put_ref,
                                                shmem_reduce_slots_ref, slot)

__all__ = ["CpuHeap", "CudaHeap", "shmem_put", "shmem_put_ref",
           "shmem_reduce_slots", "shmem_reduce_slots_ref", "slot"]
