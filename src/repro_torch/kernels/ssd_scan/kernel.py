"""Build and bind the CUDA SSD-scan kernels (``csrc/ssd_scan.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

Two wrappers, one per TPU kernel they replace: :func:`ssd_chunk_cuda`
(``ssd_chunk_pallas``) and :func:`ssd_apply_cuda` (``ssd_apply_pallas``).
Each checks devices, dtypes, shapes and layouts, allocates its outputs
(and the chunk pass's fp32 scores scratch) with ``torch.empty``, launches
on the current stream, raises if the launch was refused, and adds one to
its ``launches`` count.  x, Bm and Cm are read through a row stride, so
column slices of a packed activation need no copy.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import compile_library

_SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)     # SSD head dims P the kernels take
DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernels."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [vp] * 9 + [i] * 11 + [vp]
    lib.ssd_chunk_launch.restype = i
    lib.ssd_apply_launch.argtypes = [vp] * 5 + [i] * 9 + [vp]
    lib.ssd_apply_launch.restype = i
    lib.ssd_max_chunk.argtypes = []
    lib.ssd_max_chunk.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def _check_device(name, tensors, contiguous):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if not all(t.is_contiguous() for t in contiguous):
        raise ValueError(f"{name}: operands must be contiguous")


def _row_stride(name, t: torch.Tensor) -> int:
    """Elements between consecutive positions of ``t``, whose last two dims
    must be dense and whose leading dims must step evenly over positions (a
    column slice of a packed activation qualifies); raises otherwise."""
    *lead, g, n = t.shape
    st = t.stride()
    if not ((n == 1 or st[-1] == 1) and (g == 1 or st[-2] == n)):
        raise ValueError(f"{name}: the last two dims must be contiguous")
    row, span = None, 1           # span: positions per step of dim i
    for i in reversed(range(len(lead))):
        if lead[i] > 1:
            if row is None:
                row = st[i] // span if st[i] % span == 0 else -1
            if st[i] != row * span:
                raise ValueError(f"{name}: positions must be evenly spaced, "
                                 f"got strides {st} for shape "
                                 f"{tuple(t.shape)}")
        span *= lead[i]
    return g * n if row is None else row


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 over all chunks, on the card.

    x (B, S, H, P) float32 or bfloat16; dt (B, S, H) and A (H,) float32;
    Bm/Cm (B, S, G, N) in x's dtype; S a multiple of ``chunk``.  dt and A
    are contiguous; x, Bm and Cm need dense last two dims and evenly spaced
    positions.  Returns
    ``(y_intra (B, nc, L, H, P) in x's dtype, states (B, nc, H, N, P) fp32,
    cumexp (B, nc, L, H) fp32)``."""
    _check_device("ssd_chunk_cuda", (x, dt, A, Bm, Cm), (dt, A))
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x/Bm/Cm must share float32 or bfloat16, got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}/{A.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = int(chunk)
    lib = build()
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if min(B, S, H, G, N) < 1 or not 1 <= L <= lib.ssd_max_chunk() \
            or S % L or H % G or P not in HEAD_DIMS:
        raise ValueError(f"unsupported geometry B={B} S={S} chunk={L} H={H} "
                         f"P={P} G={G} N={N} (P in {HEAD_DIMS}, chunk <= "
                         f"{lib.ssd_max_chunk()}, G | H, chunk | S)")
    rows = [_row_stride("ssd_chunk_cuda", t) for t in (x, Bm, Cm)]
    nc = S // L
    kw = dict(device=x.device)
    y = torch.empty((B, nc, L, H, P), dtype=x.dtype, **kw)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32, **kw)
    cumexp = torch.empty((B, nc, L, H), dtype=torch.float32, **kw)
    scores = torch.empty((B, nc, G, L, L), dtype=torch.float32, **kw)
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), states.data_ptr(), cumexp.data_ptr(),
            scores.data_ptr(), B, nc, L, H, P, G, N, *rows,
            int(x.dtype == torch.bfloat16), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err}")
    ssd_chunk_cuda.launches += 1
    return y, states, cumexp


ssd_chunk_cuda.launches = 0


def ssd_apply_cuda(y_intra: torch.Tensor, Cm: torch.Tensor,
                   cumexp: torch.Tensor, states_in: torch.Tensor
                   ) -> torch.Tensor:
    """Pass 2, on the card: ``y = y_intra + (C_t . states_in[c]) * cumexp``.

    y_intra (B, nc, L, H, P) float32 or bfloat16; Cm (B, nc, L, G, N) in the
    same dtype; cumexp (B, nc, L, H) and states_in (B, nc, H, N, P) float32.
    Cm needs dense last two dims and evenly spaced positions; the others
    are contiguous.  Returns y (B, nc, L, H, P) in y_intra's dtype."""
    _check_device("ssd_apply_cuda", (y_intra, Cm, cumexp, states_in),
                  (y_intra, cumexp, states_in))
    if y_intra.dtype not in DTYPES or Cm.dtype != y_intra.dtype:
        raise TypeError(f"y_intra/Cm must share float32 or bfloat16, got "
                        f"{y_intra.dtype}/{Cm.dtype}")
    if cumexp.dtype != torch.float32 or states_in.dtype != torch.float32:
        raise TypeError("cumexp and states_in must be float32")
    if y_intra.ndim != 5 or Cm.ndim != 5:
        raise ValueError(f"bad ranks: y_intra {tuple(y_intra.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    B, nc, L, H, P = y_intra.shape
    G, N = Cm.shape[3], Cm.shape[4]
    if tuple(Cm.shape[:3]) != (B, nc, L) \
            or tuple(cumexp.shape) != (B, nc, L, H) \
            or tuple(states_in.shape) != (B, nc, H, N, P):
        raise ValueError(f"bad shapes: y_intra {tuple(y_intra.shape)}, Cm "
                         f"{tuple(Cm.shape)}, cumexp {tuple(cumexp.shape)}, "
                         f"states_in {tuple(states_in.shape)}")
    if min(B, nc, L, H, G, N) < 1 or H % G or P not in HEAD_DIMS:
        raise ValueError(f"unsupported geometry H={H} P={P} G={G} N={N} "
                         f"(P in {HEAD_DIMS}, G | H)")
    c_row = _row_stride("ssd_apply_cuda", Cm)
    lib = build()
    out = torch.empty_like(y_intra)
    with torch.cuda.device(y_intra.device):
        err = lib.ssd_apply_launch(
            y_intra.data_ptr(), Cm.data_ptr(), cumexp.data_ptr(),
            states_in.data_ptr(), out.data_ptr(), B, nc, L, H, P, G, N,
            c_row, int(y_intra.dtype == torch.bfloat16),
            _stream(y_intra.device))
    if err != 0:
        raise RuntimeError(f"ssd_apply kernel launch failed: CUDA error {err}")
    ssd_apply_cuda.launches += 1
    return out


ssd_apply_cuda.launches = 0
