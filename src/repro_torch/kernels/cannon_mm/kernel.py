"""Build and bind the CUDA matmul kernels (``csrc/cannon_mm.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`matmul_cuda` is the wrapper of the kernel family that replaces
``matmul_pallas``: a batched product ``C[p] = A[p] @ B[p]`` in which every
operand is read through its strides, so transposed views, PE stacks and
column slices go in without copies.  :func:`plan` picks the family's
variant from dtypes, shapes, strides and base alignment alone (it runs on
the CPU with no card):

  * ``wgmma_tma`` — bf16, A and B with unit column strides and 16-byte
    aligned rows, batches and bases: TMA into a ring of shared-memory
    stages, ``wgmma`` on the tensor cores;
  * ``mma_general`` — bf16, any other layout (transposed views among them);
  * ``f32_vec`` — fp32, each operand with a unit stride in one of its two
    dimensions and 16-byte aligned otherwise (the Cannon stacks, and the
    transposed views of the backward): 16-byte loads, warp-tiled FMAs;
  * ``f32_general`` — fp32, any other layout.

The wrapper checks devices, dtypes and shapes, allocates C with
``torch.empty``, launches the planned variant on the current stream,
raises if the launch was refused, and adds one to ``launches`` and to
``by_variant[variant]``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import counted
from repro_torch.kernels.build import compile_library, launch_error

_SRC = Path(__file__).resolve().parent / "csrc" / "cannon_mm.cu"
_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Variant(NamedTuple):
    code: int                   # the Variant code in cannon_mm.cu
    tile: Tuple[int, int, int]  # output tile (BM, BN) and depth tile BK
    kernel: str                 # the CUDA kernel's name (profiler traces)


VARIANTS = {
    "f32_general": Variant(0, (128, 128, 8), "mm_f32_kernel"),
    "f32_vec": Variant(1, (128, 256, 16), "mm_f32_vec_kernel"),
    "mma_general": Variant(2, (128, 128, 32), "mm_bf16_kernel"),
    "wgmma_tma": Variant(3, (128, 256, 64), "mm_wgmma_tma_kernel"),
}
# wgmma_tma's TMA boxes, (columns, rows, batch): A 128 x 64, B as 64 x 64
WGMMA_BOX_A = (64, 128, 1)
WGMMA_BOX_B = (64, 64, 1)

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


class Plan(NamedTuple):
    """What :func:`plan` decided for one call.

    ``a_strides`` / ``b_strides``: the (batch, row, col) strides handed to
    the kernel (a size-1 dim's stride replaced by a harmless value);
    ``layout``: f32_vec's bits (1: A's unit stride runs along M, 2: B's
    along N); ``tma``: wgmma_tma's tensor-map arguments for A then B."""
    variant: str
    tile: Tuple[int, int, int]
    a_strides: Tuple[int, int, int]
    b_strides: Tuple[int, int, int]
    layout: int = 0
    tma: Optional[Tuple[int, ...]] = None


def _unit(size: int, stride: int) -> bool:
    return size == 1 or stride == 1


def _multiple(size: int, stride: int, q: int) -> bool:
    """A stride that is a positive multiple of q elements, or unused."""
    return size == 1 or (stride > 0 and stride % q == 0)


def tma_args(shape, strides, esz: int, box) -> Optional[Tuple[int, ...]]:
    """The arguments of a 3-D TMA tensor map over one (P, R, C) operand, or
    None when TMA cannot read it: dims (C, R, P), innermost first; byte
    strides of rows and batches; the box (columns, rows, 1).  TMA needs a
    unit column stride and the other strides in multiples of 16 bytes
    (below 2^40); the base's 16-byte alignment is the caller's to check.
    A size-1 dim's stride is unused and replaced by the dense one."""
    P, R, C = shape
    sb, sr, sc = strides
    if not _unit(C, sc):
        return None
    row = sr * esz if R > 1 else -(-C * esz // 16) * 16
    batch = sb * esz if P > 1 else R * row
    if (row <= 0 or batch <= 0 or row % 16 or batch % 16
            or max(row, batch) >= 1 << 40 or max(shape) >= 1 << 32):
        return None
    return (C, R, P, row, batch, *box)


def _sane(shape, strides, unit: Optional[int] = None) -> Tuple[int, ...]:
    """Strides with a size-1 dim's (unused) stride set to 0, and dim
    ``unit``'s to 1 (f32_vec's unit-stride dim, which may be of size 1)."""
    return tuple(1 if d == unit else 0 if n == 1 else s
                 for d, (n, s) in enumerate(zip(shape, strides)))


def plan(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> Plan:
    """The variant of the cannon_mm family that takes ``a @ b``, from
    dtypes, shapes, strides and ``data_ptr() % 16`` alone.  ``a`` (M, K) or
    (P, M, K), ``b`` (K, N) or (P, K, N), as :func:`matmul_cuda` takes
    them; ``out_dtype`` does not change the choice."""
    a3 = a if a.ndim == 3 else a.unsqueeze(0)
    b3 = b if b.ndim == 3 else b.unsqueeze(0)
    return _plan(a.dtype, tuple(a3.shape), a3.stride(), tuple(b3.shape),
                 b3.stride(),
                 a3.data_ptr() % 16 == 0 and b3.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=256)
def _plan(dtype, sa, ta, sb, tb, ok16) -> Plan:
    """:func:`plan` on a layout; cached, since a Cannon call repeats a few
    layouts many times."""
    if dtype == torch.bfloat16:
        if ok16:
            ma = tma_args(sa, ta, 2, WGMMA_BOX_A)
            mb = tma_args(sb, tb, 2, WGMMA_BOX_B)
            if ma is not None and mb is not None:
                return _make("wgmma_tma", sa, ta, sb, tb, tma=ma + mb)
        return _make("mma_general", sa, ta, sb, tb)
    # fp32: each operand k-fast or x-fast (x: M for A, N for B)
    (P, M, K), N = sa, sb[2]
    a_k = _unit(K, ta[2]) and _multiple(M, ta[1], 4)
    a_x = _unit(M, ta[1]) and _multiple(K, ta[2], 4)
    b_x = _unit(N, tb[2]) and _multiple(K, tb[1], 4)
    b_k = _unit(K, tb[1]) and _multiple(N, tb[2], 4)
    if (ok16 and (a_k or a_x) and (b_x or b_k)
            and _multiple(P, ta[0], 4) and _multiple(P, tb[0], 4)):
        ax, bx = not a_k, b_x
        return Plan("f32_vec", VARIANTS["f32_vec"].tile,
                    _sane(sa, ta, 1 if ax else 2),
                    _sane(sb, tb, 2 if bx else 1), int(ax) | 2 * int(bx))
    return _make("f32_general", sa, ta, sb, tb)


def _make(variant, sa, ta, sb, tb, tma=None) -> Plan:
    return Plan(variant, VARIANTS[variant].tile, _sane(sa, ta),
                _sane(sb, tb), tma=tma)


@functools.lru_cache(maxsize=256)
def _tma_array(tma: Tuple[int, ...]):
    return (ctypes.c_ulonglong * len(tma))(*tma)


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernels."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "cannon_mm")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cannon_mm_launch.argtypes = ([i] + [vp] * 3 + [i] * 4 + [ll] * 9
                                     + [i] * 4 + [vp, vp])
    lib.cannon_mm_launch.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` on the card with an fp32 accumulator, cast to ``out_dtype``
    (a's dtype when None), by the variant :func:`plan` names.

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
    pl = plan(a3, b3, out_dtype)
    out = torch.empty((P, M, N), dtype=out_dtype, device=a.device)
    lib = build()
    tma = None if pl.tma is None else _tma_array(pl.tma)
    with torch.cuda.device(a.device):
        err = lib.cannon_mm_launch(
            a.device.index, a3.data_ptr(), b3.data_ptr(), out.data_ptr(), P,
            M, N, K, *pl.a_strides, *pl.b_strides, *out.stride(),
            _CODE[a.dtype], _CODE[out_dtype], VARIANTS[pl.variant].code,
            pl.layout, tma,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise launch_error(f"cannon_mm ({pl.variant})", err)
    matmul_cuda.launches += 1
    matmul_cuda.by_variant[pl.variant] += 1
    return out if batched else out[0]


def reset_counts() -> None:
    """Set ``matmul_cuda.launches`` and every ``by_variant`` count to 0."""
    matmul_cuda.launches = 0
    matmul_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


counted(matmul_cuda)
reset_counts()
