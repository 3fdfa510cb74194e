"""Build and bind the CUDA SSD-scan kernels (``csrc/ssd_scan.cu``).

The source is compiled at first use with ``nvcc`` for ``sm_90a``
(:func:`repro_torch.kernels.build.compile_library`) and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

Three wrappers: :func:`ssd_chunk_cuda` (``ssd_chunk_pallas``),
:func:`ssd_apply_cuda` (``ssd_apply_pallas``) and
:func:`ssd_scan_fused_cuda` (both, for a sequence of one chunk, with the
state passing between them).  :func:`plan` picks, from dtypes, shapes,
strides and ``data_ptr() % 16`` alone, the route of a scan (one fused
launch, or the two passes), the variant (``mma``: bf16 on the tensor
cores; ``simt``: fp32 FMAs on the CUDA cores) and the staging of the mma
variant (16-byte ``cp.async``, or scalar loads for a layout that is not
16-byte aligned).  Each wrapper checks devices, dtypes, shapes and layouts,
allocates its outputs with ``torch.empty``, launches on the current stream,
raises if the launch was refused, and adds one to its ``launches`` count
(the two passes also to ``by_variant[variant]``).
x, Bm and Cm are read through a row stride, so column slices of a packed
activation need no copy.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import counted, forbid_grad
from repro_torch.kernels.build import compile_library, launch_error

_SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)     # SSD head dims P the kernels take
DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 1024                     # = ssd_max_chunk() of the library
FUSED_MAX_STATE = 128                # N the tensor-core kernels take

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


class Plan(NamedTuple):
    """route: ``"fused"`` (:func:`ssd_scan_fused_cuda`) or ``"two_pass"``
    (:func:`ssd_chunk_cuda`, the state passing, :func:`ssd_apply_cuda`);
    variant: ``"mma"`` or ``"simt"``; staging: ``"async"`` or
    ``"scalar"`` (always ``"scalar"`` for simt, which stages through
    registers)."""
    route: str
    variant: str
    staging: str


def route(dtype: torch.dtype, N: int, n_chunks: int) -> Tuple[str, str]:
    """(route, variant) of a scan from x's dtype, the state size and the
    number of chunks: bf16 with N <= 128 (every config of the repo) runs on
    the tensor cores, at one chunk in one fused launch; fp32 (whose 1e-4
    gates would not hold for x split into bf16 parts) and larger N run on
    the CUDA cores, in two passes."""
    variant = "mma" if dtype == torch.bfloat16 and N <= FUSED_MAX_STATE \
        else "simt"
    fused = variant == "mma" and n_chunks == 1
    return ("fused" if fused else "two_pass"), variant


def plan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
         chunk: int) -> Plan:
    """The route, variant and staging of a scan of ``x`` (B, S, H, P) with
    ``Bm``/``Cm`` (B, S, G, N) in chunks of ``chunk``.  Raises ValueError
    for a layout the kernels cannot read (see :func:`_row_stride`)."""
    return _layout(x, Bm, Cm, chunk)[0]


def _layout(x, Bm, Cm, chunk) -> Tuple[Plan, Tuple[int, ...]]:
    """:func:`plan` and the row strides of x, Bm and Cm."""
    return _plan(x.dtype, x.shape[1] // max(1, chunk),
                 tuple((tuple(t.shape), t.stride()) for t in (x, Bm, Cm)),
                 all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)))


@functools.lru_cache(maxsize=256)
def _plan(dtype, n_chunks, layouts, aligned) -> Tuple[Plan, Tuple[int, ...]]:
    """Cached per layout: the engine repeats a few layouts in every layer."""
    N = layouts[1][0][-1]
    rt, variant = route(dtype, N, max(1, n_chunks))
    rows = tuple(_row_stride_of("plan", *lay) for lay in layouts)
    ok = (variant == "mma" and aligned and N % 8 == 0
          and all(r % 8 == 0 for r in rows))
    return Plan(rt, variant, "async" if ok else "scalar"), rows


def apply_plan(y_intra: torch.Tensor, Cm: torch.Tensor) -> Plan:
    """Variant and staging of the apply pass on ``Cm`` (B, nc, L, G, N)."""
    N = Cm.shape[-1]
    _, variant = route(y_intra.dtype, N, 2)
    ok = (variant == "mma" and N % 8 == 0 and Cm.data_ptr() % 16 == 0
          and _row_stride("plan", Cm) % 8 == 0)
    return Plan("two_pass", variant, "async" if ok else "scalar")


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernels."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [i] + [vp] * 8 + [i] * 13 + [vp]
    lib.ssd_chunk_launch.restype = i
    lib.ssd_apply_launch.argtypes = [i] + [vp] * 5 + [i] * 11 + [vp]
    lib.ssd_apply_launch.restype = i
    lib.ssd_fused_launch.argtypes = [i] + [vp] * 8 + [i] * 10 + [vp]
    lib.ssd_fused_launch.restype = i
    limits = {"ssd_max_chunk": MAX_CHUNK,
              "ssd_max_state_fused": FUSED_MAX_STATE}
    for name in limits:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    if any(getattr(lib, name)() != v for name, v in limits.items()):
        raise RuntimeError("ssd_scan library limits differ from kernel.py's")
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
    return _row_stride_of(name, tuple(t.shape), t.stride())


def _row_stride_of(name, shape, st) -> int:
    *lead, g, n = shape
    if not ((n == 1 or st[-1] == 1) and (g == 1 or st[-2] == n)):
        raise ValueError(f"{name}: the last two dims must be contiguous")
    row, span = None, 1           # span: positions per step of dim i
    for i in reversed(range(len(lead))):
        if lead[i] > 1:
            if row is None:
                row = st[i] // span if st[i] % span == 0 else -1
            if st[i] != row * span:
                raise ValueError(f"{name}: positions must be evenly spaced, "
                                 f"got strides {st} for shape {shape}")
        span *= lead[i]
    return g * n if row is None else row


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_scan(name, x, dt, A, Bm, Cm, chunk):
    """Checks shared by the chunk pass and the fused scan; returns
    (B, S, H, P, G, N, L)."""
    _check_device(name, (x, dt, A, Bm, Cm), (dt, A))
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{name}: x/Bm/Cm must share float32 or bfloat16, "
                        f"got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got "
                        f"{dt.dtype}/{A.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"{name}: bad ranks: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = int(chunk)
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"{name}: bad shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if min(B, S, H, G, N) < 1 or not 1 <= L <= MAX_CHUNK or S % L \
            or H % G or P not in HEAD_DIMS:
        raise ValueError(f"{name}: unsupported geometry B={B} S={S} "
                         f"chunk={L} H={H} P={P} G={G} N={N} (P in "
                         f"{HEAD_DIMS}, chunk <= {MAX_CHUNK}, G | H, "
                         f"chunk | S)")
    return B, S, H, P, G, N, L


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 over all chunks, on the card, in one launch.

    x (B, S, H, P) float32 or bfloat16; dt (B, S, H) and A (H,) float32;
    Bm/Cm (B, S, G, N) in x's dtype; S a multiple of ``chunk``.  dt and A
    are contiguous; x, Bm and Cm need dense last two dims and evenly spaced
    positions.  Returns
    ``(y_intra (B, nc, L, H, P) in x's dtype, states (B, nc, H, N, P) fp32,
    cumexp (B, nc, L, H) fp32)``."""
    forbid_grad("ssd_chunk_cuda", x, dt, A, Bm, Cm)
    B, S, H, P, G, N, L = _check_scan("ssd_chunk_cuda", x, dt, A, Bm, Cm,
                                      chunk)
    pl, rows = _layout(x, Bm, Cm, L)
    lib = build()
    nc = S // L
    kw = dict(device=x.device)
    y = torch.empty((B, nc, L, H, P), dtype=x.dtype, **kw)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32, **kw)
    cumexp = torch.empty((B, nc, L, H), dtype=torch.float32, **kw)
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.device.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
            cumexp.data_ptr(), B, nc, L, H, P, G, N, *rows,
            int(x.dtype == torch.bfloat16),
            int(pl.variant == "mma"), int(pl.staging == "async"),
            _stream(x.device))
    if err != 0:
        raise launch_error(f"ssd_chunk ({pl.variant})", err)
    ssd_chunk_cuda.launches += 1
    ssd_chunk_cuda.by_variant[pl.variant] += 1
    return y, states, cumexp


counted(ssd_chunk_cuda)
ssd_chunk_cuda.by_variant = {"mma": 0, "simt": 0}


def ssd_apply_cuda(y_intra: torch.Tensor, Cm: torch.Tensor,
                   cumexp: torch.Tensor, states_in: torch.Tensor
                   ) -> torch.Tensor:
    """Pass 2, on the card: ``y = y_intra + (C_t . states_in[c]) * cumexp``.

    y_intra (B, nc, L, H, P) float32 or bfloat16; Cm (B, nc, L, G, N) in the
    same dtype; cumexp (B, nc, L, H) and states_in (B, nc, H, N, P) float32.
    Cm needs dense last two dims and evenly spaced positions; the others
    are contiguous.  Returns y (B, nc, L, H, P) in y_intra's dtype."""
    forbid_grad("ssd_apply_cuda", y_intra, Cm, cumexp, states_in)
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
    pl = apply_plan(y_intra, Cm)
    c_row = _row_stride("ssd_apply_cuda", Cm)
    lib = build()
    out = torch.empty_like(y_intra)
    with torch.cuda.device(y_intra.device):
        err = lib.ssd_apply_launch(
            y_intra.device.index, y_intra.data_ptr(), Cm.data_ptr(),
            cumexp.data_ptr(), states_in.data_ptr(), out.data_ptr(), B, nc,
            L, H, P, G, N, c_row, int(y_intra.dtype == torch.bfloat16),
            int(pl.variant == "mma"), int(pl.staging == "async"),
            _stream(y_intra.device))
    if err != 0:
        raise launch_error(f"ssd_apply ({pl.variant})", err)
    ssd_apply_cuda.launches += 1
    ssd_apply_cuda.by_variant[pl.variant] += 1
    return out


counted(ssd_apply_cuda)
ssd_apply_cuda.by_variant = {"mma": 0, "simt": 0}


def ssd_scan_fused_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor,
                        init: torch.Tensor, *, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole scan of a one-chunk sequence (S == ``chunk``), on the card,
    in one launch: pass 1, the state passing (the state entering the chunk
    is ``init``) and pass 2.

    x (B, S, H, P) bfloat16 and Bm/Cm (B, S, G, N) bfloat16 with N <= 128,
    laid out as for :func:`ssd_chunk_cuda`; dt (B, S, H), A (H,) and init
    (B, H, N, P) float32 and contiguous.  Returns ``(y (B, S, H, P)
    bfloat16, final (B, H, N, P) fp32)``: y_intra is rounded to bf16 before
    ``(C . init) * cumexp`` is added in fp32 and rounded again, and ``final
    = exp(cum_last) * init + state``, as the two passes and the state
    passing compute them."""
    forbid_grad("ssd_scan_fused_cuda", x, dt, A, Bm, Cm, init)
    B, S, H, P, G, N, L = _check_scan("ssd_scan_fused_cuda", x, dt, A, Bm,
                                      Cm, chunk)
    _check_device("ssd_scan_fused_cuda", (x, init), (init,))
    pl, rows = _layout(x, Bm, Cm, L)
    if pl.route != "fused":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"ssd_scan_fused_cuda takes bfloat16 x, got "
                            f"{x.dtype}")
        raise ValueError(f"ssd_scan_fused_cuda: one chunk (S == chunk) and "
                         f"N <= {FUSED_MAX_STATE} only, got S={S} chunk={L} "
                         f"N={N}")
    if init.dtype != torch.float32 or tuple(init.shape) != (B, H, N, P):
        raise ValueError(f"ssd_scan_fused_cuda: init must be float32 "
                         f"{(B, H, N, P)}, got {init.dtype} "
                         f"{tuple(init.shape)}")
    lib = build()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_fused_launch(
            x.device.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), init.data_ptr(), y.data_ptr(),
            final.data_ptr(), B, L, H, P, G, N, *rows,
            int(pl.staging == "async"),
            _stream(x.device))
    if err != 0:
        raise launch_error("ssd_fused", err)
    ssd_scan_fused_cuda.launches += 1
    return y, final


counted(ssd_scan_fused_cuda)
