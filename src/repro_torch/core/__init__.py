"""The paper's hybrid OpenCL + OpenSHMEM model, on one card.

  shmem          — PGAS layer: ShmemGrid over a leading PE dimension
  cannon         — Cannon systolic GEMM (the paper's technique) + allgather
                   (pure-OpenCL analogue) + SUMMA + decode GEMV
  hybrid         — OpenCL-style host API (HybridKernel / CommandQueue)
  epiphany_model — analytical Epiphany-III model reproducing paper Table 1
"""

from repro_torch.core.shmem import ShmemGrid
from repro_torch.core.cannon import (
    allgather_matmul, block_2d, cannon_matmul, cannon_matmul_crot, gemv2d,
    summa_matmul, unblock_2d)
from repro_torch.core.hybrid import CommandQueue, HybridKernel
