"""The paper's Table 1 demonstration: hybrid Cannon against pure OpenCL.

  PYTHONPATH=src python -m repro_torch.launch.table1
  PYTHONPATH=src python -m repro_torch.launch.table1 --device cpu --sizes 32 64

prints the analytic Table 1 rows (the calibrated Epiphany-III model of
:mod:`repro_torch.core.epiphany_model`), then runs the two programming
models as :class:`~repro_torch.core.hybrid.HybridKernel` programs on an
emulated 4x4 PE grid through a :class:`~repro_torch.core.hybrid.
CommandQueue`:

  * hybrid — ``cannon_matmul`` with B read in pre-skewed (the OpenCL kernel
    with a nested OpenSHMEM job);
  * opencl — ``allgather_matmul`` (every PE fetches its full panels).

For each size it reports the max error against a host fp64 product of the
same operands, the time per call (CUDA events, on the card only), the wire bytes
per call (per PE, from the grid's counter) and the allgather/Cannon bytes
ratio.  A size is ``n`` (an n x n x n fp32 product) or ``MxKxN``, either
with an optional ``:bfloat16``.  The default sizes are the paper's n = 128
and 512, then n = 4096 and 8192 fp32, and qwen2-0.5b's MLP up-projection
over a 4096-token prefill, (4096 x 896) @ (896 x 4864) in bf16.  It runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import (CommandQueue, HybridKernel, ShmemGrid,
                              allgather_matmul, block_2d, cannon_matmul,
                              unblock_2d)
from repro_torch.core.epiphany_model import table1_report
from repro_torch.device import resolve_device

DEFAULT_SIZES = ("128", "512", "4096", "8192", "4096x896x4864:bfloat16")
Q = 4                                   # the paper's 4x4 Epiphany-III grid
ITERS = 3                               # timed calls per kernel and size


def parse_size(spec: str) -> Tuple[int, int, int, torch.dtype]:
    """``n`` or ``MxKxN``, with an optional ``:float32`` / ``:bfloat16``."""
    dims, _, dtype = spec.partition(":")
    sizes = [int(d) for d in dims.split("x")]
    if len(sizes) == 1:
        sizes *= 3
    if len(sizes) != 3 or any(s < Q or s % Q for s in sizes):
        raise ValueError(f"size {spec!r}: need n or MxKxN, each a multiple "
                         f"of {Q}")
    return (*sizes, getattr(torch, dtype or "float32"))


def hybrid_kernel(g, a, b):
    """OpenCL kernel + nested OpenSHMEM job: Cannon, B read in pre-skewed."""
    return cannon_matmul(g, a, b, preskewed_b=True)


def opencl_kernel(g, a, b):
    """Pure-OpenCL analogue: re-fetch the operand panels on every call."""
    return allgather_matmul(g, a, b)


def operands(M: int, K: int, N: int, dtype: torch.dtype, seed: int,
             device: torch.device):
    """A (M, K) and B (K, N) from a seed (numpy, standard normal), rounded
    to ``dtype``, on ``device``; and their fp64 product on the host, the
    reference (computed from the rounded operands, moved to ``device``)."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dtype)
    B = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(dtype)
    C = A.double() @ B.double()
    return A.to(device), B.to(device), C.to(device)


def _ms_per_call(queue: CommandQueue, kern: HybridKernel, a, b) -> float:
    """Device time per call, CUDA events around ``ITERS`` enqueues."""
    queue.enqueue(kern, a, b)
    queue.finish()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(ITERS):
        queue.enqueue(kern, a, b)
    t1.record()
    queue.finish()
    return t0.elapsed_time(t1) / ITERS


def measure(queue: CommandQueue, spec: str, A, B, C) -> dict:
    """Both programming models on A @ B (global operands, blocked here)
    against the fp64 product C: errors, per-PE wire bytes and FLOPs, and
    on the card the time per call."""
    M, K = A.shape
    N = B.shape[1]
    a_blocks = block_2d(A, Q, Q)                       # symmetric heap objects
    blocks = {"hybrid": block_2d(B, Q, Q, skew_b=True),   # "read in pre-skewed"
              "opencl": block_2d(B, Q, Q)}
    row = dict(size=spec, M=M, K=K, N=N, dtype=str(A.dtype).split(".")[-1])
    scale = float(C.abs().max())
    for name, fn in (("hybrid", hybrid_kernel), ("opencl", opencl_kernel)):
        kern = HybridKernel(fn, grid=ShmemGrid(Q, Q), name=f"{name}_{spec}")
        out = queue.enqueue(kern, a_blocks, blocks[name])
        queue.finish()
        ev = queue.events[kern.name]
        err = float((unblock_2d(out, Q, Q).to(C.device, C.dtype) - C)
                    .abs().max())
        row[f"{name}_max_abs_err"] = err
        row[f"{name}_max_rel_err"] = err / scale
        row[f"{name}_wire_bytes"] = ev.collective_bytes
        row[f"{name}_flops_per_pe"] = ev.flops
        row[f"{name}_ms"] = (_ms_per_call(queue, kern, a_blocks, blocks[name])
                             if queue.device.type == "cuda"
                             else "not measured")
        del out
    row["bytes_ratio"] = row["opencl_wire_bytes"] / row["hybrid_wire_bytes"]
    return row


def run(sizes, device, *, seed: int = 0) -> List[dict]:
    """One row of :func:`measure` per size."""
    device = resolve_device(device)
    queue = CommandQueue(device)
    rows = []
    for spec in sizes:
        M, K, N, dtype = parse_size(spec)
        A, B, C = operands(M, K, N, dtype, seed, device)
        rows.append(measure(queue, spec, A, B, C))
        del A, B, C
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--sizes", nargs="+", default=list(DEFAULT_SIZES))
    args = ap.parse_args(argv)

    print("Paper Table 1, reproduced analytically (Epiphany-III model):")
    rows, meta = table1_report()
    for r in rows:
        print(f"  n={r['n']:4d}  opencl {r['model_opencl']:7.1f} "
              f"(paper {r['paper_opencl']})  hybrid {r['model_hybrid']:7.1f} "
              f"(paper {r['paper_hybrid']})  speedup {r['model_speedup']}x")
    print(f"  fitted: off-chip {meta['offchip_bw_MBs']} MB/s, "
          f"{meta['eff_gflops']} GFLOPS, max_rel_err {meta['max_rel_err']}")

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions; no times)")
    print(f"\nLive, emulated 4x4 PE grid on {name}:")
    for row in run(args.sizes, device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
