"""Build and bind the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`flash_attention_cuda` is the wrapper of the kernel that replaces
``flash_attention_pallas``: it checks devices, dtypes, shapes and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch was refused, and adds one to its
``launches`` count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import compile_library

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [i] * 8 + [ctypes.c_float, i, vp])
    lib.flash_attention_launch.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on the card.  q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D),
    contiguous, one dtype (float32 or bfloat16), D in ``HEAD_DIMS``, Hkv
    dividing Hq, ``q_offset`` >= 0.  Returns (B, Hq, Sq, D) in q's dtype."""
    tensors = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention_cuda: every operand must be on one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_cuda: operands must be contiguous")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or D not in HEAD_DIMS or Hq % Hkv \
            or min(B, Hq, Sq, Skv) < 1 or max(B, Hq) > 65535:
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (D in {HEAD_DIMS}, Hkv | Hq)")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    lib = build()
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, int(q_offset), int(bool(causal)), scale,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
