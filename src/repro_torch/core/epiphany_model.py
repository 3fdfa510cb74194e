"""Analytical Epiphany-III cost model — faithful reproduction of paper Table 1.

A copy of ``repro.core.epiphany_model`` (numpy only): importing it from
``repro`` would pull in JAX.

No Epiphany hardware exists in this environment, so the paper's benchmark is
reproduced the way the paper itself argues it: from the data-movement
structure of the two programming models.  We count, from first principles,
the exact bytes each model moves across each level of the Epiphany memory
hierarchy for an n x n Cannon matmul on a q x q core grid, then evaluate a
three-constant hardware model (off-chip bandwidth, effective per-chip FLOP/s,
per-step sync overhead) calibrated by least squares against the paper's six
MFLOPS entries.  The model must reproduce BOTH columns of Table 1 and the
2.3x speedup from a single consistent set of constants — that is the
validation that our byte accounting (and hence our JAX port of the two
models) captures the paper's mechanism.

Byte accounting (fp32, per full C = A @ B):

  pure OpenCL (no inter-core reuse — every core fetches its current A/B
  submatrix from off-chip global memory at every Cannon step):
      offchip_read  = q steps * q^2 cores * 2 mats * (n/q)^2 * 4B  = 8 n^2 q
      offchip_write = n^2 * 4B
      noc           = 0

  hybrid OpenCL+OpenSHMEM (fetch once, then shmem_put neighbor shifts):
      offchip_read  = q^2 cores * 2 mats * (n/q)^2 * 4B            = 8 n^2
      offchip_write = n^2 * 4B
      noc           = 2 mats * (q-1 shifts + skew~1) * q^2 * (n/q)^2 * 4B

  FLOPs = 2 n^3 either way; barriers: q steps (hybrid) vs q (baseline's
  global-memory round also synchronizes per step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# Paper Table 1 (MFLOPS).
PAPER_TABLE1 = {
    32: {"opencl": 218.0, "hybrid": 504.0},
    64: {"opencl": 424.0, "hybrid": 1000.0},
    128: {"opencl": 794.0, "hybrid": 1817.0},
}

EPIPHANY_III = dict(
    cores=16,
    grid_q=4,
    clock_hz=600e6,
    peak_flops=19.2e9,          # 16 cores * 600 MHz * 2 flop (FMA)
    noc_bw=4.8e9,               # ~8 B/cycle/link aggregate per core, eMesh
)


@dataclasses.dataclass(frozen=True)
class Volumes:
    flops: float
    offchip_bytes: float
    noc_bytes: float
    steps: int


def volumes(n: int, q: int = 4, model: str = "hybrid") -> Volumes:
    sub = n // q
    assert sub * q == n
    flops = 2.0 * n ** 3
    write = 4.0 * n ** 2
    if model == "opencl":
        read = q * (q * q) * 2 * sub * sub * 4.0     # re-read per step
        noc = 0.0
    elif model == "hybrid":
        read = (q * q) * 2 * sub * sub * 4.0          # read once
        noc = 2 * q * (q * q) * sub * sub * 4.0       # skew + (q-1) shifts
    else:
        raise ValueError(model)
    return Volumes(flops, read + write, noc, steps=q)


@dataclasses.dataclass(frozen=True)
class HardwareFit:
    offchip_bw: float       # B/s effective (non-DMA host-memory access)
    eff_flops: float        # achieved FLOP/s of the compiled inner kernel
    step_overhead: float    # s per Cannon step (barrier + loop control)

    def time(self, v: Volumes, noc_bw: float = EPIPHANY_III["noc_bw"]) -> float:
        return (v.offchip_bytes / self.offchip_bw
                + v.flops / self.eff_flops
                + v.noc_bytes / (noc_bw * EPIPHANY_III["cores"])
                + v.steps * self.step_overhead)

    def mflops(self, n: int, model: str, q: int = 4) -> float:
        v = volumes(n, q, model)
        return v.flops / self.time(v) / 1e6


def calibrate(table: Dict[int, Dict[str, float]] = PAPER_TABLE1,
              q: int = 4) -> Tuple[HardwareFit, float]:
    """Least-squares fit of the 3 hardware constants to the 6 paper numbers.

    Returns (fit, max relative error over the six entries).  Grid-searched in
    log space (the problem is tiny); constants are physically bounded:
    off-chip BW in [50 MB/s, 1 GB/s] (Parallella shared-memory reads),
    eff FLOP/s in [1, 19.2] GFLOPS, overhead in [0, 100 us] per step.
    """
    best, best_err = None, np.inf
    for bw in np.geomspace(50e6, 1e9, 60):
        for ef in np.geomspace(1e9, 19.2e9, 60):
            for ov in np.linspace(0.0, 100e-6, 21):
                fit = HardwareFit(bw, ef, ov)
                errs = []
                for n, row in table.items():
                    for model, ref in row.items():
                        pred = fit.mflops(n, model, q)
                        errs.append((pred - ref) / ref)
                err = float(np.sqrt(np.mean(np.square(errs))))
                if err < best_err:
                    best, best_err = fit, err
    # max |rel err|
    max_err = max(
        abs(best.mflops(n, m, q) - ref) / ref
        for n, row in table.items() for m, ref in row.items())
    return best, max_err


def table1_report(q: int = 4) -> List[dict]:
    fit, max_err = calibrate(q=q)
    rows = []
    for n in sorted(PAPER_TABLE1):
        pred_o = fit.mflops(n, "opencl", q)
        pred_h = fit.mflops(n, "hybrid", q)
        ref_o = PAPER_TABLE1[n]["opencl"]
        ref_h = PAPER_TABLE1[n]["hybrid"]
        rows.append(dict(
            n=n,
            paper_opencl=ref_o, model_opencl=round(pred_o, 1),
            paper_hybrid=ref_h, model_hybrid=round(pred_h, 1),
            paper_speedup=round(ref_h / ref_o, 2),
            model_speedup=round(pred_h / pred_o, 2),
        ))
    meta = dict(
        offchip_bw_MBs=round(fit.offchip_bw / 1e6, 1),
        eff_gflops=round(fit.eff_flops / 1e9, 2),
        step_overhead_us=round(fit.step_overhead * 1e6, 1),
        max_rel_err=round(max_err, 3),
    )
    return rows, meta
