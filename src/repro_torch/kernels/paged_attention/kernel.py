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

With bf16 operands the kernel splits each slot's block table over
:func:`split_count` blocks per tile, a function of shapes alone (so the
wrapper never waits on the card), writes each split's partials to fp32
scratch that the wrapper allocates, and merges them in the same launch:
the last split of a tile to finish, counted by a per-tile atomic counter,
merges them all.  The counters are zeroed once per device and kept on
the wrapper (``paged_attention_cuda.counters``; the kernel leaves them
zero), so two calls must not run at once on two streams of one device.
An engine that captures its steps as CUDA graphs sizes them first
(:func:`reserve_split_counters`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import counted, forbid_grad
from repro_torch.kernels.build import (MAX_SMEM, compile_library,
                                       launch_error)

_SRC = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
# head sizes the bf16 kernel is instantiated for (160: stablelm-12b); the
# fp32 kernel takes any size its shared memory holds
HEAD_DIMS = (8, 16, 32, 64, 128, 160)

N_SM = 132                # streaming multiprocessors of an H100 SXM
TC_ROWS = 128             # bf16 kernel: query rows per block at most

_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds, ptxas report
build_info: dict = {}


def tc_tile_l(group: int, L: int) -> int:
    """Query positions per block of the bf16 kernel (its
    ``make_tc_geometry``): up to 16, and at most 128 rows of ``group``
    heads each."""
    return max(1, min(16, TC_ROWS // group, L))


def split_count(B: int, kvh: int, n_qtiles: int, T: int,
                n_sm: int = N_SM) -> int:
    """Blocks per (slot, kv head, q tile) over the block table: enough for
    about one block per SM when the tiles alone do not fill the card, never
    more than the table has entries.  Split s takes entries
    ``[s * T // n, (s + 1) * T // n)``."""
    tiles = B * kvh * n_qtiles
    if tiles >= n_sm or T <= 1:
        return 1
    return min(T, -(-n_sm // tiles))


def split_ranges(T: int, n_split: int):
    """The table entry range of each split, as the kernel cuts it."""
    return [(s * T // n_split, (s + 1) * T // n_split)
            for s in range(n_split)]


def split_span(rows: int, hd: int) -> int:
    """Scratch floats of one split's partials (the kernel's ``tc_span``):
    acc (rows, hd), then m and l, rounded up to whole float4s."""
    return rows * hd + -(-2 * rows // 4) * 4


def launch_plan(B: int, Hq: int, L: int, hd: int, kvh: int, T: int,
                stride: int, bf16: bool) -> Tuple[int, int, int]:
    """(n_split, q tiles, scratch floats) of one launch geometry; raises if
    the kernel does not take it or it needs more shared memory than a
    block has."""
    smem = build().paged_attention_smem_bytes(Hq, L, hd, kvh, stride,
                                              int(bf16))
    if not 0 <= smem <= MAX_SMEM:
        raise ValueError(f"geometry Hq={Hq} kvh={kvh} hd={hd} stride={stride} "
                         f"is not taken or needs more shared memory than a "
                         f"block has")
    if not bf16:
        return 1, 0, 0
    tile_l = tc_tile_l(Hq // kvh, L)
    n_qt = -(-L // tile_l)
    n_split = split_count(B, kvh, n_qt, T)
    part = 0 if n_split == 1 else \
        B * kvh * n_qt * n_split * split_span(Hq // kvh * tile_l, hd)
    return n_split, n_qt, part


def _split_counters(device: torch.device, n: int) -> torch.Tensor:
    """The int32 split counters of ``device``, one per (slot, kv head,
    q tile), zeroed once and kept on the wrapper (the kernel leaves them
    zero); at least ``n`` of them.  A buffer that grows is replaced, and
    the old one is kept alive: a captured CUDA graph may still hold its
    address.  Growing is refused while a graph is being captured, where
    the zeroing would run only on replay: :func:`reserve_split_counters`
    sizes the buffer before any capture."""
    held = paged_attention_cuda.counters
    buf = held.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged_attention_cuda: {n} split counters are needed "
                f"during a CUDA graph capture; reserve them before it")
        if buf is not None:
            paged_attention_cuda.retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        held[device.index] = buf
    return buf


def reserve_split_counters(device: torch.device, B: int, Hq: int, kvh: int,
                           lengths) -> None:
    """Size ``device``'s split counters for every launch at batch up to
    ``B`` with query lengths ``lengths`` (bf16 operands), before a step
    that launches the kernel is captured."""
    n = max(B * kvh * -(-L // tc_tile_l(Hq // kvh, L)) for L in lengths)
    _split_counters(torch.device(device), n)


def build() -> ctypes.CDLL:
    """Compile (when the hashed library is missing) and load the kernel."""
    global _lib
    if _lib is not None:
        return _lib
    lib, info = compile_library(_SRC, "paged_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = (
        [i] + [vp] * 10 + [i] * 11 + [ctypes.c_longlong, ctypes.c_float, i,
                                     vp])
    lib.paged_attention_launch.restype = i
    lib.paged_attention_smem_bytes.argtypes = [i] * 6
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
    dtype as q (float32 or bfloat16; bf16 arenas 16-byte aligned); table
    (B, T) int32 physical page ids (-1 = unallocated); q_pos (B, L) int32
    global query positions."""
    forbid_grad("paged_attention_cuda", q, kc, vc)
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
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (kc.data_ptr() % 16 or vc.data_ptr() % 16):
        raise ValueError("paged_attention_cuda: bf16 arenas must be 16-byte "
                         "aligned")
    T = table.shape[1]
    n_split, n_qt, part = launch_plan(B, Hq, L, hd, kvh, T, stride, bf16)
    scale = float(scale if scale is not None else hd ** -0.5)
    dev = q.device
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hq, L), dtype=torch.float32, device=dev)
    acc = torch.empty((B, Hq, L, hd), dtype=torch.float32, device=dev)
    part_ptr = count_ptr = 0
    if n_split > 1:
        scratch = torch.empty(part, dtype=torch.float32, device=dev)
        part_ptr = scratch.data_ptr()     # held until the launch
        count_ptr = _split_counters(dev, B * kvh * n_qt).data_ptr()
    args = (dev.index, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            table.data_ptr(), q_pos.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), part_ptr, count_ptr, B, Hq, L, hd, kvh, T, stride,
            n_loc, row, qrows, n_split, part, scale, int(bf16))
    lib = build()
    with torch.cuda.device(dev):
        err = lib.paged_attention_launch(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error("paged_attention", err)
    paged_attention_cuda.launches += 1
    return m, l, acc


counted(paged_attention_cuda)
paged_attention_cuda.counters: Dict[int, torch.Tensor] = {}
paged_attention_cuda.retired: List[torch.Tensor] = []
