#!/usr/bin/env python3
"""Time the grouped GEMM of two checkouts on one CUDA card, in turns.

    python3 src/repro_torch/launch/compare_gmm.py [--grad] OTHER_CHECKOUT \
        [THIS_CHECKOUT]

Runs four worker processes in the order other, this, this, other; each
imports its own checkout's ``src/`` and ``chip_smoke.py`` (so it runs as
a script, not with ``-m``) and, with that checkout's kernels built from
its sources, times ``grouped_mm_cuda`` on the variant its ``plan`` names
at the shapes of ``chip_smoke.phase_gmm_timing``: qwen3-moe's two expert
products (w1: K 4096 -> N 3072, w2: K 1536 -> N 4096, 128 experts, rows
routed top-8 from one seed) at M = T * k of batch-8 decode, verify at
k = 4 and the len16, len64 and len256 chunks, bf16.  It also times w1
with the silu x up that follows it in the MoE block: the checkout's
``grouped_mm_swiglu`` where it has one, else its grouped_mm and the torch
lines.  Every row is one JSON line: CUDA-events ms around back-to-back
calls, the grouped GEMM kernel's own device ms from torch.profiler (the
mean per launch), the device ms of every kernel of the call (with the
glue) and the least time the card could take.  Last, each worker serves qwen3-moe-235b-a22b at full width
with 8 of its 94 layers (random weights from seed 0, the smoke's engine
setting) and profiles one batch-8 len256 prefill step (a replayed graph):
its device busy time and the grouped GEMM's share, which the host clock
(spreading 2x between calls) cannot give, and how that step's router
spread the rows over the experts.  The card's name and power
limit come first.  Needs one card.

With ``--grad`` each worker times the backward instead: dgrad and wgrad
(``grouped_mm_dgrad_cuda``, ``grouped_mm_wgrad_cuda`` on the variant the
checkout's routing picks) at qwen3-moe's training shapes (M 65536 = batch
8 x len 1024 x top-8, rows routed uniformly and on the smoke's skewed
routing), events ms and the kernel's device ms, then four AdamW steps of
the 2-layer qwen3-moe training run of ``chip_smoke.phase_train`` (8-bit
moments, one batch of 8 x 1024 tokens): each step's synchronised wall and
the steady one (the median of steps 2-4).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

STAGES = ("decode", "verify", "len16", "len64", "len256")
ARCH, LAYERS = "qwen3-moe-235b-a22b", 8
TRAIN_M = 65536                 # backward rows: batch 8 x len 1024 x top-8


def glue(h):
    F = h.shape[1] // 2
    return torch.nn.functional.silu(h[:, :F].float()).to(h.dtype) * h[:, F:]


def busy_ms(fn, iters):
    """Device time per call of every CUDA kernel ``fn`` starts (the glue's
    casts and products with the grouped GEMM), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def time_kernels(cs, label, run):
    from repro_torch.kernels.grouped_mm import kernel
    fused = getattr(kernel, "grouped_mm_swiglu_cuda", None)
    kernel.build()
    rng = np.random.default_rng(9)
    E, k = cs.QWEN3_MOE_EXPERTS["E"], cs.QWEN3_MOE_EXPERTS["k"]
    for prod, (K, N) in cs.GMM_PRODUCTS.items():
        w = cs.gmm_weights(E, K, N, torch.bfloat16, seed=11)
        for stage in STAGES:
            M = cs.GMM_M[stage]
            offsets = cs.routed_offsets(rng, M // k, E, k)
            off = torch.from_numpy(offsets).cuda()
            x = torch.from_numpy(rng.standard_normal(
                (M, K), "float32")).to("cuda", torch.bfloat16)
            calls = {"": lambda i: kernel.grouped_mm_cuda(x, w, off)}
            if prod == "w1":
                calls[" + silu x up"] = (
                    (lambda i: fused(x, w, off)) if fused else
                    (lambda i: glue(kernel.grouped_mm_cuda(x, w, off))))
            for suffix, fn in calls.items():
                print(json.dumps(dict(
                    checkout=label, run=run, shape=f"{prod} {stage}{suffix}",
                    variant=kernel.plan(x, w), fused=bool(suffix and fused),
                    ms=cs.cuda_ms(fn, 10),
                    device_ms=cs.device_ms(fn, 5, ("gmm_",)),
                    call_busy_ms=busy_ms(fn, 5),
                    bound_ms=cs.gmm_bound(offsets, K, N, torch.bfloat16)[0])),
                    flush=True)
            del x
        del w
        torch.cuda.empty_cache()


def record_routing(cfg):
    """Wrap the MoE block's first grouped product so that it keeps a copy
    of the offsets of every batch-8 len256 call (M = 8 * 256 * top_k rows),
    eager or captured: a captured copy is refreshed at each replay.
    Returns the list the copies go to."""
    import repro_torch.models.moe as moe
    name = "grouped_mm_swiglu" if hasattr(moe, "grouped_mm_swiglu") \
        else "grouped_mm"
    first, kept = getattr(moe, name), []

    def wrapped(x, w, offsets):
        if x.shape[0] == 8 * 256 * cfg.top_k and w.shape[1] == cfg.d_model:
            kept.append(offsets.clone())
        return first(x, w, offsets)
    setattr(moe, name, wrapped)
    return kept


def routing_stats(kept, n_layers):
    """Rows an expert at the profiled step, per layer: the most, how many
    experts hold more than 256 rows (wgmma_tma's row group) and none."""
    sizes = [np.diff(o.cpu().numpy()) for o in kept[-n_layers:]]
    return dict(max_rows=[int(r.max()) for r in sizes],
                experts_over_256=[int((r > 256).sum()) for r in sizes],
                empty_experts=[int((r == 0).sum()) for r in sizes])


def prefill_step(cs, label, run):
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                          ServingEngine)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    kept = record_routing(cfg)
    gen = torch.Generator("cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    ec = EngineConfig(s_max=512, buckets=(1, 2, 4, 8), block_pos_stride=16,
                      prefill_chunks=(16, 64, 256), device="cuda")
    eng = ServingEngine(cfg, params=params, engine_cfg=ec)
    # build the batch-8 len256 step once on other prompts, so the profiled
    # one replays it and misses the prefix cache
    rng = np.random.default_rng(70)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 300).tolist(),
                   SamplingParams(max_tokens=1))
    eng.drain()
    row = cs.phase_prefill_profile(eng, {"grouped_mm": ("gmm_",)})
    print(json.dumps(dict(checkout=label, run=run,
                          shape="qwen3-moe len256 prefill step",
                          device_busy_ms=row["device_busy_ms"],
                          step_wall_ms=row["step_wall_ms"],
                          kernels=row["kernels"],
                          grouped_mm=row["kernel_shares"]["grouped_mm"],
                          top=row["top"][:2],
                          routing=routing_stats(kept, LAYERS))),
          flush=True)


def time_grad(cs, label, run):
    from repro_torch.kernels.grouped_mm import kernel
    kernel.build()
    rng = np.random.default_rng(32)
    E, k = cs.QWEN3_MOE_EXPERTS["E"], cs.QWEN3_MOE_EXPERTS["k"]
    for prod, (K, N) in cs.GMM_PRODUCTS.items():
        w = cs.gmm_weights(E, K, N, torch.bfloat16, seed=21)
        for stage in ("train", "skewed"):
            if stage == "skewed":
                offsets, M = cs.skewed_offsets(rng, TRAIN_M // k, E, k,
                                               tail=64)
                M = int(M)
            else:
                M = TRAIN_M
                offsets = cs.routed_offsets(rng, M // k, E, k)
            off = torch.from_numpy(offsets).cuda()
            gen = torch.Generator("cuda").manual_seed(M + K)
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            dy = torch.randn((M, N), generator=gen, device="cuda").bfloat16()
            for kind in ("dgrad", "wgrad"):
                fn = getattr(kernel, f"grouped_mm_{kind}_cuda")
                args = (dy, w, off) if kind == "dgrad" else (x, dy, off)
                before = dict(fn.by_variant)
                fn(*args)
                variant = next(v for v, n in fn.by_variant.items()
                               if n > before.get(v, 0))
                print(json.dumps(dict(
                    checkout=label, run=run, shape=f"{prod} {stage}",
                    fn=f"grouped_mm_{kind}", variant=variant, M=M,
                    ms=cs.cuda_ms(lambda i: fn(*args), 5),
                    device_ms=cs.device_ms(lambda i: fn(*args), 5,
                                           (f"gmm_{kind}_",)),
                    bound_ms=cs.grad_bound(kind, offsets, K, N,
                                           torch.bfloat16)[0])), flush=True)
            del x, dy
        del w
        torch.cuda.empty_cache()


def train_steps(cs, label, run, steps=4):
    from repro_torch.launch import train as launch
    from repro_torch.optim.adamw import AdamWConfig
    cfg = launch.train_config(ARCH, full=True, layers=2)
    launch.check_fit(cfg, "cuda", 8)
    opt_cfg = AdamWConfig(lr=cs.TRAIN_LR, warmup_steps=10, decay_steps=100,
                          state_bits=8)
    params, opt, step_fn = launch.setup(cfg, device="cuda", opt_cfg=opt_cfg)
    dc = launch.data_config(cfg, cs.TRAIN_SEQ, cs.TRAIN_BATCH, full=True)
    batch = launch.device_batch(dc, 0, "cuda")
    walls, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(checkout=label, run=run,
                          shape="qwen3-moe 2-layer train step",
                          step_wall_ms=walls,
                          steady_step_ms=float(np.median(walls[1:])),
                          losses=losses)), flush=True)


def worker(root: Path, label: str, run: int, grad: bool) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    if grad:
        time_grad(cs, label, run)
        train_steps(cs, label, run)
    else:
        time_kernels(cs, label, run)
        prefill_step(cs, label, run)


def main() -> int:
    args = sys.argv[1:]
    grad = "--grad" in args
    args = [a for a in args if a != "--grad"]
    if args and args[0] == "--worker":
        worker(Path(args[1]).resolve(), args[2], int(args[3]), grad)
        return 0
    if not torch.cuda.is_available() or len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    this = Path(args[1] if len(args) == 2
                else Path(__file__).resolve().parents[3]).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for run, (root, label) in enumerate(((other, "other"), (this, "this"),
                                         (this, "this"), (other, "other"))):
        subprocess.run([sys.executable, __file__, "--worker", str(root),
                        label, str(run)] + ["--grad"] * grad, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
