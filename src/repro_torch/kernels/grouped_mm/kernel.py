"""Build and bind the CUDA grouped GEMM (``csrc/grouped_mm.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

:func:`grouped_mm_cuda` is the wrapper of the kernel that replaces
``lax.ragged_dot`` in the MoE block (``src/repro/models/moe.py:116,120``);
:func:`grouped_mm_swiglu_cuda` launches the same kernel with the silu x up
epilogue fused into it (``moe.py:116-119``).  Both are forward only and
refuse inputs that require grad under grad mode
(:func:`repro_torch.kernels.forbid_grad`); training reaches them through
the autograd functions of :mod:`.ops`, whose backward launches
:func:`grouped_mm_dgrad_cuda` (dx = dy w[e]^T per expert) and
:func:`grouped_mm_wgrad_cuda` (dw[e] = x[rows]^T dy[rows]), each in two
variants, picked by :func:`grad_route` from the dtype: ``wgmma_tma`` for
bf16 at any rows an expert (``wgmma`` m64n256k16 on a TMA ring; dgrad over
row-tile slots found on the card, wgrad persistent), ``simt`` for fp32.
For the forward, :func:`plan` picks the variant from dtype and shapes
alone (it runs on the CPU with no card, and never reads the offsets):

  * ``wgmma_tma`` — bf16 with at least :data:`WGMMA_MIN_ROWS` rows an
    expert on average (the prefill chunks): TMA into a ring of shared
    memory stages, ``wgmma`` on the tensor cores, each weight strip read
    once for up to 256 rows of its expert;
  * ``mma`` — bf16 with fewer rows an expert (decode, verify):
    ``mma.sync`` tiles fed by ``cp.async``;
  * ``simt`` — fp32: CUDA-core FMAs, any K and N.

bf16 needs K and N multiples of 8 (N of 16 with the epilogue) and 16-byte
aligned operands.  Each wrapper checks devices, dtypes, shapes and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch was refused, and adds one to its
``launches`` and to ``by_variant[variant]``.  It never reads ``offsets`` on
the host: the kernel reads them on the card, so a call can be captured in a
CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import counted, forbid_grad
from repro_torch.kernels.build import compile_library, launch_error
from repro_torch.kernels.cannon_mm.kernel import tma_args

_SRC = Path(__file__).resolve().parent / "csrc" / "grouped_mm.cu"
# the CUDA kernel of each variant (its name in profiler traces) and its code
# in grouped_mm.cu
VARIANTS = {"simt": "gmm_simt_kernel", "mma": "gmm_mma_kernel",
            "wgmma_tma": "gmm_wgmma_tma_kernel"}
_CODE = {"simt": 0, "mma": 1, "wgmma_tma": 2}
MAX_EXPERTS = 65534          # the grid's y dimension holds E + 1 blocks
# bf16 takes wgmma_tma from this many rows an expert on average (M / E);
# chosen from chip_smoke.py's gmm_timing (PERF.md, row 6)
WGMMA_MIN_ROWS = 16
# wgmma_tma's TMA boxes, (columns, rows, batch): 64 x 64 of x and of w
WGMMA_BOX = (64, 64, 1)

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
    lib.grouped_mm_launch.argtypes = [i] + [vp] * 4 + [i] * 6 + [vp, vp]
    lib.grouped_mm_launch.restype = i
    lib.grouped_mm_grad_launch.argtypes = ([i] * 2 + [vp] * 4 + [i] * 5
                                           + [vp] * 3)
    lib.grouped_mm_grad_launch.restype = i
    build_info.update(info)
    _lib = lib
    return lib


def route(dtype: torch.dtype, M: int, K: int, N: int, E: int,
          swiglu: bool = False) -> str:
    """The variant for an (M, K) x (E, K, N) call in ``dtype``; raises on
    what no variant takes."""
    if dtype == torch.float32:
        if swiglu and N % 2:
            raise ValueError(f"grouped_mm_swiglu needs an even N, got {N}")
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm takes float32 or bfloat16, got {dtype}")
    if K % 8 or N % (16 if swiglu else 8):
        raise ValueError(f"bf16 grouped_mm needs K and N multiples of 8"
                         f"{' (N of 16 with the epilogue)' if swiglu else ''}"
                         f", got K={K}, N={N}")
    return "wgmma_tma" if M >= WGMMA_MIN_ROWS * E else "mma"


def plan(x: torch.Tensor, w: torch.Tensor, swiglu: bool = False) -> str:
    """The variant that takes ``grouped_mm(x, w, offsets)`` (or, with
    ``swiglu``, ``grouped_mm_swiglu``), from dtypes and shapes; raises on
    what none takes."""
    if x.dtype != w.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    return route(x.dtype, x.shape[0], *w.shape[1:], w.shape[0], swiglu)


def _map(P: int, R: int, C: int):
    """Tensor-map arguments of a contiguous bf16 (P, R, C) operand in
    64 x 64 boxes, or None where TMA cannot read it."""
    return tma_args((P, R, C), (R * C, C, 1), 2, WGMMA_BOX)


@functools.lru_cache(maxsize=64)
def wgmma_tma_args(M: int, K: int, N: int, E: int):
    """wgmma_tma's 16 tensor-map arguments: x as (K, M, 1), then w as
    (N, K, E), both contiguous bf16 in 64 x 64 boxes (``tma_args``)."""
    ax, aw = _map(1, M, K), _map(E, K, N)
    if ax is None or aw is None:
        raise ValueError(f"grouped_mm: TMA cannot read x ({M}, {K}) or w "
                         f"({E}, {K}, {N})")
    return ax + aw


@functools.lru_cache(maxsize=64)
def _tma_array(args):
    return (ctypes.c_ulonglong * len(args))(*args)


def _launch(fn, x, w, offsets, swiglu, variant):
    tensors = (x, w, offsets)
    name = fn.__name__
    forbid_grad(name, x, w)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.ndim != 2 or w.ndim != 3 or offsets.ndim != 1:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)}")
    M, K = x.shape
    E, Kw, N = w.shape
    if Kw != K or offsets.numel() != E + 1 or min(M, K, N, E) < 1 \
            or E > MAX_EXPERTS:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, offsets {tuple(offsets.shape)}")
    planned = plan(x, w, swiglu)
    variant = variant or planned
    if variant not in VARIANTS or (variant == "simt") != (planned == "simt"):
        raise ValueError(f"{name}: variant {variant!r} does not take "
                         f"{x.dtype}")
    if variant != "simt" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")
    tma = _tma_array(wgmma_tma_args(M, K, N, E)) \
        if variant == "wgmma_tma" else None
    lib = build()
    out = torch.empty((M, N // 2 if swiglu else N), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.grouped_mm_launch(
            x.device.index, x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), M, K, N, E, _CODE[variant], int(swiglu), tma,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise launch_error(f"{name} ({variant})", err)
    fn.launches += 1
    fn.by_variant[variant] += 1
    return out


def grouped_mm_cuda(x: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor, *,
                    variant: Optional[str] = None) -> torch.Tensor:
    """Grouped product on the card: x (M, K), w (E, K, N), offsets (E + 1,)
    int32, contiguous, on one device.  Returns (M, N) in x's dtype; see
    :func:`repro_torch.kernels.grouped_mm.grouped_mm`.  ``variant``
    overrides :func:`plan` among the variants of x's dtype (tests and
    timings)."""
    return _launch(grouped_mm_cuda, x, w, offsets, False, variant)


def grouped_mm_swiglu_cuda(x: torch.Tensor, w: torch.Tensor,
                           offsets: torch.Tensor, *,
                           variant: Optional[str] = None) -> torch.Tensor:
    """The grouped product with the silu x up epilogue on the card: w
    (E, K, 2F) gate | up; returns (M, F); see
    :func:`repro_torch.kernels.grouped_mm.grouped_mm_swiglu`."""
    return _launch(grouped_mm_swiglu_cuda, x, w, offsets, True, variant)


# ---------------------------------------------------------------------------
# The backward products.
# ---------------------------------------------------------------------------

# the CUDA kernel of each backward variant, per product (profiler names)
GRAD_VARIANTS = {kind: {v: f"gmm_{kind}_{v}_kernel"
                        for v in ("simt", "wgmma_tma")}
                 for kind in ("dgrad", "wgrad")}
_KIND = {"dgrad": 0, "wgrad": 1}


def grad_route(dtype: torch.dtype, K: int, N: int) -> str:
    """The backward variant for a product whose weights are (E, K, N):
    ``simt`` for fp32, ``wgmma_tma`` for bf16 (K and N multiples of 8) at
    any rows an expert; raises on what neither takes."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm backward takes float32 or bfloat16, "
                        f"got {dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"bf16 grouped_mm backward needs K and N multiples "
                         f"of 8, got K={K}, N={N}")
    return "wgmma_tma"


@functools.lru_cache(maxsize=64)
def grad_tma_args(kind: str, M: int, K: int, N: int, E: int):
    """The backward wgmma_tma's tensor-map arguments, contiguous bf16
    operands in 64 x 64 boxes: dgrad (16) dy as (N, M, 1), then w as (N, K,
    E) (the forward's map); wgrad (24) x as (K, M, 1) (the forward's), dy as
    (N, M, 1), then its output dw as (N, K, E), which it stores with TMA."""
    maps = ((_map(1, M, N), _map(E, K, N)) if kind == "dgrad"
            else (_map(1, M, K), _map(1, M, N), _map(E, K, N)))
    if None in maps:
        raise ValueError(f"grouped_mm {kind}: TMA cannot read its operands "
                         f"at M={M}, K={K}, N={N}, E={E}")
    return sum(maps, ())


def _grad_launch(fn, kind, a, b, offsets, out_shape, M, K, N, E):
    name = fn.__name__
    tensors = (a, b, offsets)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if offsets.dtype != torch.int32 or offsets.ndim != 1 \
            or offsets.numel() != E + 1:
        raise ValueError(f"{name}: offsets must be int32 (E + 1,), got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"{name}: operands must share float32 or bfloat16, "
                        f"got {a.dtype}/{b.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if min(M, K, N, E) < 1 or E > MAX_EXPERTS:
        raise ValueError(f"{name}: bad sizes M={M}, K={K}, N={N}, E={E}")
    variant = grad_route(a.dtype, K, N)
    if variant != "simt" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")
    tma = _tma_array(grad_tma_args(kind, M, K, N, E)) \
        if variant == "wgmma_tma" else None
    lib = build()
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    # wgrad's wgmma_tma hands out its tiles from a counter on the card
    counter = torch.empty(1, dtype=torch.int32, device=a.device) \
        if tma is not None and kind == "wgrad" else None
    with torch.cuda.device(a.device):
        err = lib.grouped_mm_grad_launch(
            a.device.index, _KIND[kind], a.data_ptr(), b.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), M, K, N, E, _CODE[variant],
            tma,
            counter.data_ptr() if counter is not None else None,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise launch_error(f"{name} ({variant})", err)
    fn.launches += 1
    fn.by_variant[variant] += 1
    return out


def grouped_mm_dgrad_cuda(dy: torch.Tensor, w: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """dgrad on the card: dy (M, N), w (E, K, N), offsets (E + 1,) int32,
    contiguous, one device.  Returns dx (M, K) in dy's dtype: rows
    ``offsets[e]:offsets[e + 1]`` of dy times ``w[e]^T``, rows of no expert
    zero; the variant is :func:`grad_route`'s."""
    if dy.ndim != 2 or w.ndim != 3 or dy.shape[1] != w.shape[2]:
        raise ValueError(f"grouped_mm_dgrad_cuda: bad shapes: dy "
                         f"{tuple(dy.shape)}, w {tuple(w.shape)}")
    (M, N), (E, K, _) = dy.shape, w.shape
    return _grad_launch(grouped_mm_dgrad_cuda, "dgrad", dy, w, offsets,
                        (M, K), M, K, N, E)


def grouped_mm_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """wgrad on the card: x (M, K), dy (M, N), offsets (E + 1,) int32,
    contiguous, one device.  Returns dw (E, K, N) in x's dtype: for each
    expert ``x[rows]^T dy[rows]`` over its rows in one fixed order, exact
    zeros for an expert with no rows; the variant is :func:`grad_route`'s."""
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_mm_wgrad_cuda: bad shapes: x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)}")
    (M, K), N, E = x.shape, dy.shape[1], offsets.numel() - 1
    return _grad_launch(grouped_mm_wgrad_cuda, "wgrad", x, dy, offsets,
                        (E, K, N), M, K, N, E)


def reset_counts() -> None:
    """Set every wrapper's ``launches`` and ``by_variant`` counts to 0."""
    for fn in (grouped_mm_cuda, grouped_mm_swiglu_cuda):
        fn.launches = 0
        fn.by_variant = dict.fromkeys(VARIANTS, 0)
    for fn, kind in ((grouped_mm_dgrad_cuda, "dgrad"),
                     (grouped_mm_wgrad_cuda, "wgrad")):
        fn.launches = 0
        fn.by_variant = dict.fromkeys(GRAD_VARIANTS[kind], 0)


for _fn in (grouped_mm_cuda, grouped_mm_swiglu_cuda, grouped_mm_dgrad_cuda,
            grouped_mm_wgrad_cuda):
    counted(_fn)
reset_counts()
