"""Quickstart: the hybrid OpenCL + OpenSHMEM model on one card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs the paper's Cannon matmul as a SHMEM-grid "device kernel" enqueued
through the OpenCL-style host API, for both programming models, on a 4x4
PE grid emulated over a leading PE dimension (every local block product
of a round is one ``cannon_mm`` launch on the card), and prints the
Table-1-style comparison.  The counterpart of the JAX package's
``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core import (CommandQueue, HybridKernel, ShmemGrid,
                              allgather_matmul, block_2d, cannon_matmul,
                              unblock_2d)
from repro_torch.core.epiphany_model import table1_report
from repro_torch.device import resolve_device


# --- device side: two kernels, one per programming model ------------------
def hybrid_kernel(g, a, b):         # OpenCL kernel + nested OpenSHMEM job
    return cannon_matmul(g, a, b, preskewed_b=True)


def opencl_kernel(g, a, b):         # pure-OpenCL analogue: re-fetch panels
    return allgather_matmul(g, a, b)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256,
                    help="the product's size (a multiple of 4)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- host side: an OpenCL-style command queue on the device -----------
    queue = CommandQueue(dev)
    grid = ShmemGrid(4, 4)          # 16 PEs as a logical 4x4, like OpenSHMEM

    n = args.n
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((n, n), np.float32))
    B = torch.from_numpy(rng.standard_normal((n, n), np.float32))
    want = A.double() @ B.double()                 # the host's product
    a_blocks = block_2d(A.to(dev), 4, 4)           # symmetric heap objects
    b_skewed = block_2d(B.to(dev), 4, 4, skew_b=True)   # "read in pre-skewed"
    b_plain = block_2d(B.to(dev), 4, 4)

    errors = {}
    for name, fn, bb in [("hybrid", hybrid_kernel, b_skewed),
                         ("opencl", opencl_kernel, b_plain)]:
        kern = HybridKernel(fn, grid=grid, name=name)
        out = queue.enqueue(kern, a_blocks, bb)
        queue.finish()
        ev = queue.events[name]
        errors[name] = float((unblock_2d(out, 4, 4).cpu().double()
                              - want).abs().max())
        print(f"{name:8s} kernel: max_err={errors[name]:.2e}  "
              f"flops={ev.flops:.3g}  wire_bytes={ev.collective_bytes:.3g}")

    print("\nPaper Table 1, reproduced analytically:")
    rows, meta = table1_report()
    for r in rows:
        print(f"  n={r['n']:4d}  opencl {r['model_opencl']:7.1f} "
              f"(paper {r['paper_opencl']})  hybrid {r['model_hybrid']:7.1f} "
              f"(paper {r['paper_hybrid']})  speedup {r['model_speedup']}x")
    print(f"  fitted: off-chip {meta['offchip_bw_MBs']} MB/s, "
          f"{meta['eff_gflops']} GFLOPS, max_rel_err {meta['max_rel_err']}")
    return {"max_err": errors, "events": dict(queue.events),
            "table1": rows, "table1_meta": meta}


if __name__ == "__main__":
    main()
