"""Build and bind the symmetric heap's library (``csrc/shmem_heap.cu``).

Compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface (:func:`repro_torch.kernels.build.compile_library`)
and loaded with ``ctypes``; nothing is built or loaded when this module is
imported.  A PE grid's parent builds it before it spawns the PEs
(:mod:`repro_torch.runtime.pe`), so the PEs only load it.

:class:`CudaHeap` is one PE's heap on the card: allocated, zeroed and
exported by the library, its peers' heaps opened from their IPC handles,
the device table of every PE's base address that the put kernel reads, and
a ``uint8`` tensor view of every PE's heap (the plain versions and the
gathers read through them).  :func:`shmem_put_cuda` and
:func:`shmem_reduce_slots_cuda` are the kernels' wrappers: they check
their operands, launch on the current stream, raise when the launch was
refused, and add one to their ``launches`` count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import counted, forbid_grad
from repro_torch.kernels.build import compile_library, launch_error

_SRC = Path(__file__).resolve().parent / "csrc" / "shmem_heap.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OPS = {"sum": 0, "max": 1}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "shmem_heap")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shmem_handle_bytes.argtypes = []
    lib.shmem_handle_bytes.restype = i
    lib.shmem_heap_alloc.argtypes = [i, ll, ctypes.POINTER(vp), vp]
    lib.shmem_heap_open.argtypes = [i, vp, ctypes.POINTER(vp)]
    lib.shmem_heap_close.argtypes = [i, vp]
    lib.shmem_heap_free.argtypes = [i, vp]
    lib.shmem_put_launch.argtypes = [i, vp, vp, i, i, ll, ll, vp]
    lib.shmem_reduce_slots_launch.argtypes = [i, vp, ll, ll, i, ll, i, vp,
                                              i, i, vp]
    for fn in (lib.shmem_heap_alloc, lib.shmem_heap_open,
               lib.shmem_heap_close, lib.shmem_heap_free,
               lib.shmem_put_launch, lib.shmem_reduce_slots_launch):
        fn.restype = i
    build_info.update(info)
    _lib = lib
    return lib


class _DevicePointer:
    """``__cuda_array_interface__`` of ``nbytes`` bytes at ``ptr``: lets
    ``torch.as_tensor`` view memory the library allocated or mapped."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def device_view(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    """A ``uint8`` tensor over ``nbytes`` of device memory at ``ptr`` (not
    owned: the heap frees it)."""
    t = torch.as_tensor(_DevicePointer(ptr, nbytes), device=device)
    if t.data_ptr() != ptr or t.device != device:
        raise RuntimeError(f"heap view at {ptr:#x} landed on {t.device}")
    return t


class CudaHeap:
    """One PE's symmetric heap of ``nbytes`` on ``device``.

    ``handle`` is the bytes this PE publishes; :meth:`open_peers` takes
    every PE's published handle (its own is skipped) and builds ``table``
    (int64 base addresses on the device, indexed by PE) and ``views``."""

    def __init__(self, pe: int, n_pes: int, nbytes: int,
                 device: torch.device):
        lib = build()
        self.pe, self.n_pes, self.nbytes = pe, n_pes, int(nbytes)
        self.device = torch.device(device)
        n = lib.shmem_handle_bytes()
        handle = ctypes.create_string_buffer(n)
        base = ctypes.c_void_p()
        err = lib.shmem_heap_alloc(self.device.index, self.nbytes,
                                   ctypes.byref(base), handle)
        if err:
            raise launch_error("shmem_heap alloc", err)
        self.base = int(base.value)
        self.handle = handle.raw
        self.bases: List[int] = []
        self.table: Optional[torch.Tensor] = None
        self.views: List[torch.Tensor] = []
        self._opened: List[int] = []

    def open_peers(self, handles: Sequence[bytes]) -> None:
        lib = build()
        bases = []
        for k, h in enumerate(handles):
            if k == self.pe:
                bases.append(self.base)
                continue
            ptr = ctypes.c_void_p()
            err = lib.shmem_heap_open(self.device.index, h,
                                      ctypes.byref(ptr))
            if err:
                raise launch_error(f"shmem_heap open (PE {k})", err)
            bases.append(int(ptr.value))
            self._opened.append(int(ptr.value))
        self.bases = bases
        self.table = torch.tensor(bases, dtype=torch.int64,
                                  device=self.device)
        self.views = [device_view(b, self.nbytes, self.device)
                      for b in bases]

    def close_peers(self) -> None:
        """Unmap the peers' heaps (every PE's last put has completed)."""
        lib = build()
        self.views, self.table = [], None
        for ptr in self._opened:
            err = lib.shmem_heap_close(self.device.index, ptr)
            if err:
                raise launch_error("shmem_heap close", err)
        self._opened = []

    def free(self) -> None:
        """Free this PE's heap (every peer has unmapped it)."""
        if self.base:
            err = build().shmem_heap_free(self.device.index, self.base)
            self.base = 0
            if err:
                raise launch_error("shmem_heap free", err)


def shmem_put_cuda(heap: CudaHeap, src: torch.Tensor, dst: int,
                   offset: int) -> None:
    """``shmem_put``: copy the contiguous ``src`` (on the heap's device) to
    PE ``dst``'s heap at byte ``offset``, on the current stream."""
    forbid_grad("shmem_put_cuda", src)
    if not src.is_cuda or src.device != heap.device:
        raise ValueError(f"shmem_put_cuda: src on {src.device}, heap on "
                         f"{heap.device}")
    if not src.is_contiguous():
        raise ValueError("shmem_put_cuda: src must be contiguous")
    nbytes = src.numel() * src.element_size()
    if offset < 0 or offset + nbytes > heap.nbytes:
        raise ValueError(f"shmem_put_cuda: {nbytes} bytes at {offset} "
                         f"overrun the {heap.nbytes}-byte heap")
    if nbytes == 0:
        return
    dev = heap.device
    with torch.cuda.device(dev):
        err = build().shmem_put_launch(
            dev.index, src.data_ptr(), heap.table.data_ptr(), heap.n_pes,
            dst, offset, nbytes, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise launch_error("shmem_put", err)
    shmem_put_cuda.launches += 1


def shmem_reduce_slots_cuda(heap: CudaHeap, offset: int, slot_stride: int,
                            n: int, shape, dtype: torch.dtype,
                            out_dtype: torch.dtype, op: str = "sum"
                            ) -> torch.Tensor:
    """Sum or max (``op``) over the ``n`` slots of this PE's heap that hold
    ``shape`` elements of ``dtype`` each (slot k at ``offset + k *
    slot_stride``), in slot order with an fp32 accumulator; returns a new
    ``out_dtype`` tensor of ``shape``."""
    if dtype not in DTYPES or out_dtype not in DTYPES or op not in OPS:
        raise TypeError(f"shmem_reduce_slots_cuda: {dtype} -> {out_dtype} "
                        f"({op}) not supported")
    out = torch.empty(shape, dtype=out_dtype, device=heap.device)
    numel = out.numel()
    span = (n - 1) * slot_stride + numel * torch.empty(
        (), dtype=dtype).element_size()
    if n < 1 or offset < 0 or offset + span > heap.nbytes:
        raise ValueError(f"shmem_reduce_slots_cuda: {n} slots at {offset} "
                         f"overrun the {heap.nbytes}-byte heap")
    if numel == 0:
        return out
    dev = heap.device
    with torch.cuda.device(dev):
        err = build().shmem_reduce_slots_launch(
            dev.index, heap.base, offset, slot_stride, n, numel,
            DTYPES[dtype], out.data_ptr(), DTYPES[out_dtype], OPS[op],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise launch_error("shmem_reduce_slots", err)
    shmem_reduce_slots_cuda.launches += 1
    return out


counted(shmem_put_cuda)
counted(shmem_reduce_slots_cuda)
