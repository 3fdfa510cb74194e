"""Build and bind the CUDA matmul kernel (``csrc/cannon_mm.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`matmul_cuda` is the wrapper of the one kernel that replaces
``matmul_pallas``: a batched product ``C[p] = A[p] @ B[p]`` in which every
operand is read through its strides, so transposed views, PE stacks and
column slices go in without copies.  It checks devices, dtypes and shapes,
allocates C with ``torch.empty``, launches on the current stream, raises
if the launch was refused, and adds one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import compile_library

_SRC = Path(__file__).resolve().parent / "csrc" / "cannon_mm.cu"
_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "cannon_mm")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cannon_mm_launch.argtypes = [vp] * 3 + [i] * 4 + [ll] * 9 + [i, i, vp]
    lib.cannon_mm_launch.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` on the card with an fp32 accumulator, cast to ``out_dtype``
    (a's dtype when None).

    a (M, K) and b (K, N), or stacks (P, M, K) and (P, K, N); float32 or
    bfloat16, both the same; any strides (a size-1 dim's stride is
    ignored).  Returns a contiguous (M, N) or (P, M, N) tensor."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("matmul_cuda: both operands must be on one CUDA "
                         "device")
    out_dtype = out_dtype or a.dtype
    if a.dtype not in _CODE or b.dtype != a.dtype or out_dtype not in _CODE:
        raise TypeError(f"matmul_cuda: operands must share float32 or "
                        f"bfloat16 and the output be one of them, got "
                        f"{a.dtype}/{b.dtype} -> {out_dtype}")
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(f"matmul_cuda: need (M, K) @ (K, N) or (P, M, K) @ "
                         f"(P, K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    batched = a.ndim == 3
    a3 = a if batched else a.unsqueeze(0)
    b3 = b if batched else b.unsqueeze(0)
    P, M, K = a3.shape
    if b3.shape[0] != P or b3.shape[1] != K:
        raise ValueError(f"matmul_cuda: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    N = b3.shape[2]
    if min(P, M, N, K) < 1 or P > 65535 or -(-M // 128) > 65535:
        raise ValueError(f"matmul_cuda: unsupported sizes P={P} M={M} N={N} "
                         f"K={K}")
    out = torch.empty((P, M, N), dtype=out_dtype, device=a.device)
    lib = build()
    with torch.cuda.device(a.device):
        err = lib.cannon_mm_launch(
            a3.data_ptr(), b3.data_ptr(), out.data_ptr(), P, M, N, K,
            *a3.stride(), *b3.stride(), *out.stride(), _CODE[a.dtype],
            _CODE[out_dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cannon_mm kernel launch failed: CUDA error {err}")
    matmul_cuda.launches += 1
    return out if batched else out[0]


matmul_cuda.launches = 0
