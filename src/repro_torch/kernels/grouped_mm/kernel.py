"""Build and bind the CUDA grouped GEMM (``csrc/grouped_mm.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`grouped_mm_cuda` is the wrapper of the kernel that replaces
``lax.ragged_dot`` in the MoE block (``src/repro/models/moe.py:116,120``).
:func:`plan` picks its variant from the dtype alone (it runs on the CPU
with no card):

  * ``mma`` — bf16: ``mma.sync`` tensor-core tiles fed by ``cp.async``;
    K and N multiples of 8, operands 16-byte aligned;
  * ``simt`` — fp32: CUDA-core FMAs, any K and N.

The wrapper checks devices, dtypes, shapes and contiguity, allocates the
output with ``torch.empty``, launches on the current stream, raises if the
launch was refused, and adds one to ``launches`` and to
``by_variant[variant]``.  It never reads ``offsets`` on the host: the
kernel reads them on the card, so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import counted
from repro_torch.kernels.build import compile_library

_SRC = Path(__file__).resolve().parent / "csrc" / "grouped_mm.cu"
# the CUDA kernel of each variant (its name in profiler traces)
VARIANTS = {"simt": "gmm_simt_kernel", "mma": "gmm_mma_kernel"}
MAX_EXPERTS = 65534          # the grid's y dimension holds E + 1 blocks

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "grouped_mm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.grouped_mm_launch.argtypes = [vp] * 4 + [i] * 5 + [vp]
    lib.grouped_mm_launch.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def plan(x: torch.Tensor, w: torch.Tensor) -> str:
    """The variant that takes ``grouped_mm(x, w, offsets)``; raises on
    what neither takes."""
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    if x.dtype == torch.float32:
        return "simt"
    K, N = w.shape[1:]
    if K % 8 or N % 8:
        raise ValueError(f"bf16 grouped_mm needs K and N multiples of 8, got "
                         f"K={K}, N={N}")
    return "mma"


def grouped_mm_cuda(x: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Grouped product on the card: x (M, K), w (E, K, N), offsets (E + 1,)
    int32, contiguous, on one device.  Returns (M, N) in x's dtype; see
    :func:`repro_torch.kernels.grouped_mm.grouped_mm`."""
    tensors = (x, w, offsets)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("grouped_mm_cuda: every operand must be on one CUDA "
                         "device")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_mm_cuda: operands must be contiguous")
    if x.ndim != 2 or w.ndim != 3 or offsets.ndim != 1:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)}")
    M, K = x.shape
    E, Kw, N = w.shape
    if Kw != K or offsets.numel() != E + 1 or min(M, K, N, E) < 1 \
            or E > MAX_EXPERTS:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, offsets {tuple(offsets.shape)}")
    variant = plan(x, w)
    if variant == "mma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("grouped_mm_cuda: bf16 operands must be 16-byte "
                         "aligned")
    lib = build()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.grouped_mm_launch(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            M, K, N, E, int(variant == "mma"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_mm kernel launch failed: CUDA error "
                           f"{err}")
    grouped_mm_cuda.launches += 1
    grouped_mm_cuda.by_variant[variant] += 1
    return out


counted(grouped_mm_cuda)
grouped_mm_cuda.by_variant = {v: 0 for v in VARIANTS}
