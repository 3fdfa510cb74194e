#!/usr/bin/env python3
"""Time the cannon_mm matmul kernels of two checkouts on one CUDA card, in
turns.

    python3 src/repro_torch/launch/compare_matmul.py OTHER_CHECKOUT \
        [THIS_CHECKOUT]

Runs four worker processes in the order other, this, this, other; each
imports its own checkout's ``src/`` and ``chip_smoke.py`` (so it runs as
a script, not with ``-m``) and, with that checkout's kernels built from
its sources, times ``matmul_cuda`` at the shapes of
``chip_smoke.phase_mm_timing``: 4096^3 in bf16 and in fp32, the n = 8192
Cannon round (16 x 2048^3, fp32) and the bf16 Cannon round of the
4096x896x4864 GEMM (16 x (1024 x 224) @ (224 x 1216), fp32 out), from one
seed.  Every row is one JSON line: CUDA-events ms around back-to-back
calls, the kernel's own device ms from torch.profiler (the mean per
launch), and the least time the card could take.  The card's name and
power limit come first.  Needs one card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = (("4096^3 bf16", 1, 4096, 4096, 4096, torch.bfloat16, None),
          ("4096^3 fp32", 1, 4096, 4096, 4096, torch.float32, None),
          ("16 x 2048^3 fp32", 16, 2048, 2048, 2048, torch.float32, None),
          ("16 x (1024x224)@(224x1216) bf16 -> fp32", 16, 1024, 224, 1216,
           torch.bfloat16, torch.float32))
# the kernel names of every variant, before and after the redesign
KERNELS = ("mm_f32_", "mm_bf16_", "mm_wgmma_")


def worker(root: Path, label: str, run: int) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels.cannon_mm import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel.build()
    rng = np.random.default_rng(6)
    for shape, P, M, K, N, dtype, out_dtype in SHAPES:
        a, b = cs.randn(rng, (P, M, K), dtype), cs.randn(rng, (P, K, N), dtype)

        def kern(i, a=a, b=b, out_dtype=out_dtype):
            return kernel.matmul_cuda(a, b, out_dtype=out_dtype)

        bound, by = cs.mm_bound(P, M, K, N, dtype, out_dtype or dtype)
        print(json.dumps(dict(
            checkout=label, run=run, shape=shape, ms=cs.cuda_ms(kern, 10),
            device_ms=cs.device_ms(kern, 5, KERNELS), bound_ms=bound,
            bound_by=by)), flush=True)
        del a, b
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]).resolve(), sys.argv[3], int(sys.argv[4]))
        return 0
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2] if len(sys.argv) == 3
                else Path(__file__).resolve().parents[3]).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for run, (root, label) in enumerate(((other, "other"), (this, "this"),
                                         (this, "this"), (other, "other"))):
        subprocess.run([sys.executable, __file__, "--worker", str(root),
                        label, str(run)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
