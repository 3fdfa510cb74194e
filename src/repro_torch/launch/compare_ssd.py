#!/usr/bin/env python3
"""Time the SSD scan of two checkouts on one CUDA card, in turns.

    python3 src/repro_torch/launch/compare_ssd.py OTHER_CHECKOUT \
        [THIS_CHECKOUT]

Runs four worker processes in the order other, this, this, other; each
imports its own checkout's ``src/`` and, with that checkout's kernels built
from its sources, times at batch 8, one chunk of L in {16, 64, 256},
mamba2-780m's geometry (48 heads x 64, state 128, 1 group) and bf16, with
x, B and C packed as the mamba layer hands them over:

* the op the engine calls, ``repro_torch.kernels.ssd_scan.ssd_scan(x, dt,
  A, Bm, Cm, init, chunk=L)``: CUDA-events ms around back-to-back calls,
  and the device ms and launch count of every kernel the call starts (the
  state-passing torch ops included), from torch.profiler;
* the two passes alone (``ssd_chunk_cuda``, then ``ssd_apply_cuda`` on
  ``init``): events ms, their device ms together and each pass's own;
* mamba2-780m at full width (random weights from seed 0) served by that
  checkout's engine: one batch-8 len256 chunked-prefill step (8 fresh
  300-token prompts arriving at once) after one such warm-up step, under
  torch.profiler: host wall ms, device busy ms, the SSD kernels' device ms
  and the kernels launched.

Inputs come from one seed through this checkout's ``chip_smoke.py``
helpers, which also give the least time the card could take for the
fused scan.  Every row is one JSON line, after the card's name and power
limit.  Needs one card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

THIS = Path(__file__).resolve().parents[3]
GEOM = dict(H=48, P=64, G=1, N=128)                  # mamba2-780m
# kernel names of the chunk and apply passes, before and after the redesign
CHUNK_KERNELS = ("scores_kernel", "intra_kernel", "state_kernel",
                 "chunk_mma_kernel", "chunk_simt_kernel")
APPLY_KERNELS = ("apply_kernel", "apply_mma_kernel", "apply_simt_kernel")
SSD_KERNELS = CHUNK_KERNELS + APPLY_KERNELS + ("fused_mma_kernel",)


def device_total(fn, iters):
    """(device ms, kernel launches) per call of every CUDA kernel ``fn``
    starts, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    if not rows:
        return "not measured", "not measured"
    return (sum(e.self_device_time_total for e in rows) / 1e3 / iters,
            sum(e.count for e in rows) / iters)


def prefill_step(batch=8, prompt_len=300):
    """The len256 chunked-prefill step of mamba2-780m, as described above:
    a dict of its host wall ms, device busy ms, SSD device ms and kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                          ServingEngine)
    cfg = get_config("mamba2-780m")
    gen = torch.Generator("cuda").manual_seed(0)
    eng = ServingEngine(cfg, params=init_params(cfg, generator=gen,
                                                device="cuda"),
                        engine_cfg=EngineConfig(
                            s_max=512, buckets=(1, 2, 4, 8),
                            block_pos_stride=16, prefill_chunks=(16, 64, 256),
                            device="cuda"))
    rng = np.random.default_rng(7)
    want = f"prefill_bs{batch}_len256"
    for _ in range(2):          # a warm-up step, then the one kept
        for _ in range(batch):
            eng.submit(rng.integers(0, cfg.vocab_size, prompt_len).tolist(),
                       SamplingParams(max_tokens=1))
        n0 = eng.stats.prefill_chunk_launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        step = max(eng.kernel_events().items(),
                   key=lambda kv: kv[1].last_enqueue_t)[0]
        if eng.stats.prefill_chunk_launches != n0 + 1 or step != want:
            raise RuntimeError(f"the profiled step was {step}, not {want}")
        eng.drain()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    ssd = [e for e in kern if any(n in e.key for n in SSD_KERNELS)]
    del eng
    torch.cuda.empty_cache()
    return dict(step=step, step_wall_ms=wall,
                device_busy_ms=sum(e.self_device_time_total
                                   for e in kern) / 1e3,
                ssd_device_ms=sum(e.self_device_time_total
                                  for e in ssd) / 1e3,
                ssd_launches=sum(e.count for e in ssd),
                kernels=sum(e.count for e in kern))


def worker(root: Path, label: str, run: int, n_sets: int = 4) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  THIS / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels.ssd_scan import kernel, ssd_scan
    kernel.build()
    rng = np.random.default_rng(5)
    for L in (16, 64, 256):
        sets = [cs.ssd_inputs(rng, B=8, S=L, dtype=torch.bfloat16, **GEOM)
                for _ in range(n_sets)]

        def op(i):
            x, dt, A, Bm, Cm, s0 = sets[i % n_sets]
            return ssd_scan(x, dt, A, Bm, Cm, s0, chunk=L)

        def passes(i):
            x, dt, A, Bm, Cm, s0 = sets[i % n_sets]
            yi, _, ce = kernel.ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=L)
            return kernel.ssd_apply_cuda(
                yi, Cm.reshape(8, 1, L, GEOM["G"], GEOM["N"]), ce,
                s0[:, None])

        op_dev, op_n = device_total(op, 20)
        pass_dev, pass_n = device_total(passes, 20)
        bound = cs.ssd_bound(8, 1, L, GEOM["H"], GEOM["P"], GEOM["G"],
                             GEOM["N"], 2)["ssd_scan_fused"]
        print(json.dumps(dict(
            checkout=label, run=run, L=L, B=8, dtype="bfloat16",
            op_ms=cs.cuda_ms(op, 20), op_device_ms=op_dev,
            op_kernels_per_call=op_n, passes_ms=cs.cuda_ms(passes, 20),
            passes_device_ms=pass_dev, passes_kernels_per_call=pass_n,
            chunk_device_ms=cs.device_ms(passes, 20, CHUNK_KERNELS),
            apply_device_ms=cs.device_ms(passes, 20, APPLY_KERNELS),
            fused_bound_ms=bound[0], bound_by=bound[1])), flush=True)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(dict(checkout=label, run=run, prefill=prefill_step())),
          flush=True)


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]).resolve(), sys.argv[3], int(sys.argv[4]))
        return 0
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else THIS
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
