"""Build and bind the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/repro_torch/`` at the
root of the checkout (:func:`repro_torch.kernels.build.compile_library`),
and loaded with ``ctypes``.  Nothing is built or loaded when this module is
imported: the CPU tests import it on machines with no ``nvcc`` and no card.

:func:`paged_attention_cuda` is the wrapper: it checks devices, dtypes,
shapes and contiguity, allocates the fp32 partials with ``torch.empty``,
launches on the current stream, raises if the launch was refused, and adds
one to its ``launches`` count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import MAX_SMEM, compile_library

_SRC = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "paged_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = (
        [vp] * 8 + [i] * 10 + [ctypes.c_float, i, vp])
    lib.paged_attention_launch.restype = i
    lib.paged_attention_smem_bytes.argtypes = [i] * 5
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    build_info.update(info)
    _lib = lib
    return lib


def paged_attention_cuda(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                         table: torch.Tensor, q_pos: torch.Tensor, *,
                         stride: int, row: int = 0, qrows: int = 1,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused paged flash-decode partials ``(m, l, acc)`` in fp32, on the card.

    q (B, Hq, L, hd); kc/vc (n_blocks_local, stride, kvh, hd) in the same
    dtype as q (float32 or bfloat16); table (B, T) int32 physical page ids
    (-1 = unallocated); q_pos (B, L) int32 global query positions."""
    tensors = (q, kc, vc, table, q_pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda: every operand must be on one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"q/kc/vc must share float32 or bfloat16, got "
                        f"{q.dtype}/{kc.dtype}/{vc.dtype}")
    if table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("table and q_pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda: operands must be contiguous")
    if q.ndim != 4 or kc.ndim != 4 or kc.shape != vc.shape:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, kc "
                         f"{tuple(kc.shape)}, vc {tuple(vc.shape)}")
    B, Hq, L, hd = q.shape
    n_loc, st, kvh, hd_k = kc.shape
    if st != stride or hd_k != hd or hd not in HEAD_DIMS:
        raise ValueError(f"kc {tuple(kc.shape)} does not match stride "
                         f"{stride} / head dim {hd} (supported {HEAD_DIMS})")
    if Hq % kvh or table.ndim != 2 or table.shape[0] != B \
            or tuple(q_pos.shape) != (B, L):
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, kvh {kvh}, table "
                         f"{tuple(table.shape)}, q_pos {tuple(q_pos.shape)}")
    if not 0 <= row < qrows:
        raise ValueError(f"row {row} outside [0, {qrows})")
    lib = build()
    if lib.paged_attention_smem_bytes(Hq, L, hd, kvh, stride) > MAX_SMEM:
        raise ValueError(f"geometry Hq={Hq} kvh={kvh} hd={hd} stride={stride} "
                         f"needs more shared memory than a block has")
    scale = float(scale if scale is not None else hd ** -0.5)
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, L, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), table.data_ptr(),
            q_pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            B, Hq, L, hd, kvh, table.shape[1], stride, n_loc, row, qrows,
            scale, 0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err}")
    paged_attention_cuda.launches += 1
    return m, l, acc


paged_attention_cuda.launches = 0
