#!/usr/bin/env python3
"""Each kernel library's first launch on a new thread, against the main
thread's.

    PYTHONPATH=src python3 -m repro_torch.launch.fresh_thread
    PYTHONPATH=src python3 -m repro_torch.launch.fresh_thread --case grouped_mm

Every library links its own static copy of the CUDA runtime, whose state
is per thread, so a launch is checked where that copy starts cold: in a
fresh process, the first call into the library runs on a new
``threading.Thread`` (or, for ``grouped_mm_autograd``, inside a backward
on the autograd engine's thread), and then the same call runs on the main
thread.  The case passes when the first call launches and its output
equals the main thread's bit for bit.  Cases: paged attention (bf16
decode), the three SSD entry points (bf16, their planned variants), the
cannon_mm matmul (bf16 ``wgmma_tma`` and fp32 ``f32_vec``), flash
attention (bf16), the grouped GEMM forward with and without the swiglu
epilogue (``wgmma_tma``), its dgrad and wgrad (``wgmma_tma``), the
grouped GEMM inside a backward, and the symmetric heap (a one-PE heap
allocated, opened, put into and reduced).

With no ``--case`` every case runs in a fresh process of its own, a few
at a time; each prints one JSON line and the last line sums them.  The
exit code is 1 when a case failed.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype).cuda()


def _offsets(g, M: int, E: int) -> torch.Tensor:
    """Exclusive ends of E experts' rows over M rows, uneven, on the card."""
    cut = torch.sort(torch.randint(0, M + 1, (E - 1,), generator=g)).values
    return torch.cat([torch.zeros(1, dtype=torch.long), cut,
                      torch.full((1,), M, dtype=torch.long)]).to(
        torch.int32).cuda()


def _paged():
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    g = _gen(1)
    B, Hq, kvh, hd, stride, T = 8, 14, 2, 64, 16, 32
    kc = _randn(g, (B * T, stride, kvh, hd), torch.bfloat16)
    vc = _randn(g, (B * T, stride, kvh, hd), torch.bfloat16)
    q = _randn(g, (B, Hq, 1, hd), torch.bfloat16)
    table = torch.randperm(B * T, generator=g).to(torch.int32).reshape(
        B, T).cuda()
    q_pos = torch.randint(0, T * stride, (B, 1), generator=g).to(
        torch.int32).cuda()
    return lambda: paged_attention_cuda(q, kc, vc, table, q_pos,
                                        stride=stride)


def _ssd_inputs(B, S, H, P, G, N):
    g = _gen(2)
    x = _randn(g, (B, S, H, P), torch.bfloat16)
    dt = (torch.rand((B, S, H), generator=g) * 0.1).cuda()
    A = -torch.rand((H,), generator=g).cuda() - 0.5
    Bm = _randn(g, (B, S, G, N), torch.bfloat16)
    Cm = _randn(g, (B, S, G, N), torch.bfloat16)
    return g, x, dt, A, Bm, Cm


def _ssd_chunk():
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_cuda
    _, x, dt, A, Bm, Cm = _ssd_inputs(2, 128, 48, 64, 1, 128)
    return lambda: ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=64)


def _ssd_apply():
    from repro_torch.kernels.ssd_scan.kernel import ssd_apply_cuda
    g = _gen(3)
    B, nc, L, H, P, G, N = 2, 2, 64, 48, 64, 1, 128
    yi = _randn(g, (B, nc, L, H, P), torch.bfloat16)
    Cm = _randn(g, (B, nc, L, G, N), torch.bfloat16)
    cumexp = torch.rand((B, nc, L, H), generator=g).cuda()
    s_in = _randn(g, (B, nc, H, N, P), torch.float32)
    return lambda: ssd_apply_cuda(yi, Cm, cumexp, s_in)


def _ssd_fused():
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fused_cuda
    g, x, dt, A, Bm, Cm = _ssd_inputs(8, 16, 48, 64, 1, 128)
    init = _randn(g, (8, 48, 128, 64), torch.float32)
    return lambda: ssd_scan_fused_cuda(x, dt, A, Bm, Cm, init, chunk=16)


def _matmul(dtype):
    def make():
        from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
        g = _gen(4)
        a = _randn(g, (4, 512, 256), dtype)
        b = _randn(g, (4, 256, 384), dtype)
        return lambda: matmul_cuda(a, b, out_dtype=torch.float32)
    return make


def _flash():
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    g = _gen(5)
    q = _randn(g, (1, 14, 512, 64), torch.bfloat16)
    k = _randn(g, (1, 2, 512, 64), torch.bfloat16)
    v = _randn(g, (1, 2, 512, 64), torch.bfloat16)
    return lambda: flash_attention_cuda(q, k, v, causal=True)


def _gmm_operands(K=512, N=384, E=16, M=1024):
    g = _gen(6)
    x = _randn(g, (M, K), torch.bfloat16)
    w = _randn(g, (E, K, N), torch.bfloat16, K ** -0.5)
    return g, x, w, _offsets(g, M, E)


def _gmm(swiglu):
    def make():
        from repro_torch.kernels.grouped_mm.kernel import (
            grouped_mm_cuda, grouped_mm_swiglu_cuda, route)
        _, x, w, off = _gmm_operands()
        assert route(x.dtype, *x.shape, w.shape[2], w.shape[0],
                     swiglu) == "wgmma_tma"
        fn = grouped_mm_swiglu_cuda if swiglu else grouped_mm_cuda
        return lambda: fn(x, w, off)
    return make


def _dgrad():
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_dgrad_cuda
    g, _, w, off = _gmm_operands()
    dy = _randn(g, (1024, 384), torch.bfloat16)
    return lambda: grouped_mm_dgrad_cuda(dy, w, off)


def _wgrad():
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_wgrad_cuda
    g, x, _, off = _gmm_operands()
    dy = _randn(g, (1024, 384), torch.bfloat16)
    return lambda: grouped_mm_wgrad_cuda(x, dy, off)


def _heap():
    """A one-PE heap made, opened, written and reduced inside the call, so
    the first call's every library entry (alloc, open, put, reduce_slots,
    close, free) runs on the new thread."""
    from repro_torch.kernels.shmem_heap.kernel import (
        CudaHeap, shmem_put_cuda, shmem_reduce_slots_cuda)
    g = _gen(7)
    x = _randn(g, (2, 8, 4864), torch.float32)

    def call():
        heap = CudaHeap(0, 1, 2 * x[0].numel() * 4, x.device)
        try:
            heap.open_peers([heap.handle])
            stride = x[0].numel() * 4
            for k in range(2):
                shmem_put_cuda(heap, x[k], 0, k * stride)
            out = shmem_reduce_slots_cuda(heap, 0, stride, 2, x[0].shape,
                                          torch.float32, torch.float32)
            torch.cuda.synchronize()
            return out, heap.views[0].clone()
        finally:
            heap.close_peers()
            heap.free()
    return call


# name -> a maker, run on the main thread, that builds the inputs and
# returns the call
CASES: Dict[str, Callable[[], Callable]] = {
    "paged_attention": _paged,
    "ssd_chunk": _ssd_chunk,
    "ssd_apply": _ssd_apply,
    "ssd_scan_fused": _ssd_fused,
    "cannon_mm_bf16": _matmul(torch.bfloat16),
    "cannon_mm_fp32": _matmul(torch.float32),
    "flash_attention": _flash,
    "grouped_mm": _gmm(False),
    "grouped_mm_swiglu": _gmm(True),
    "grouped_mm_dgrad": _dgrad,
    "grouped_mm_wgrad": _wgrad,
    "grouped_mm_autograd": _gmm(False),
    "shmem_heap": _heap,
}


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _on_thread(call):
    box = {}

    def body():
        try:
            box["out"] = _as_tuple(call())
            torch.cuda.synchronize()
        except BaseException as e:          # reported, not raised here
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=body, name="fresh")
    t.start()
    t.join()
    return box


def _in_backward(call):
    """``call`` as the first thing the autograd engine's thread runs."""
    box = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, grad):
            box["thread"] = threading.current_thread().name
            try:
                box["out"] = _as_tuple(call())
            except BaseException as e:
                box["error"] = f"{type(e).__name__}: {e}"
            return grad

    x = torch.ones(4, device="cuda", requires_grad=True)
    Probe.apply(x).sum().backward()
    torch.cuda.synchronize()
    return box


def run_case(name: str) -> dict:
    """One case in this process, which must not have launched the case's
    library before: the first call where the case puts it, then the same
    call on the main thread."""
    call = CASES[name]()
    first = _in_backward(call) if name.endswith("_autograd") \
        else _on_thread(call)
    row = {"case": name, "first_on": first.get("thread", "new thread")}
    if "error" in first:
        return dict(row, ok=False, error=first["error"])
    main = _as_tuple(call())
    torch.cuda.synchronize()
    equal = all(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) for a, b in zip(first["out"], main))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in main)
    return dict(row, ok=equal and finite, equal_bits=equal, finite=finite)


def prebuild() -> None:
    """Compile the six libraries here (each nvcc in a thread of its own),
    so the case processes only load them."""
    from repro_torch.kernels.cannon_mm import kernel as mm
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.grouped_mm import kernel as gmm
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.shmem_heap import kernel as heap
    from repro_torch.kernels.ssd_scan import kernel as ssd
    with ThreadPoolExecutor(max_workers=6) as pool:
        list(pool.map(lambda m: m.build(),
                      (paged, ssd, mm, flash, gmm, heap)))


def run_all(cases=None, workers: int = 6) -> list:
    """Every case in a fresh process of its own (the libraries built
    first, here); one row each."""
    cases = list(cases or CASES)
    prebuild()
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))

    def one(name):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fresh_thread",
             "--case", name], capture_output=True, text=True, timeout=600,
            env=env)
        lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
        if res.returncode not in (0, 1) or not lines:
            return {"case": name, "ok": False,
                    "error": f"exit {res.returncode}: {res.stderr[-2000:]}"}
        return json.loads(lines[-1])

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, cases))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=list(CASES), default=None,
                    help="run one case in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fresh_thread: needs a CUDA card", file=sys.stderr)
        return 2
    if args.case:
        row = run_case(args.case)
        print(json.dumps(row), flush=True)
        return 0 if row["ok"] else 1
    rows = run_all()
    for row in rows:
        print(json.dumps(row), flush=True)
    failed = [r["case"] for r in rows if not r["ok"]]
    print(json.dumps({"cases": len(rows), "failed": failed,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
