#!/usr/bin/env python3
"""Time the attention kernels of two checkouts on one CUDA card, in turns.

    python3 src/repro_torch/launch/compare_attention.py OTHER_CHECKOUT \
        [THIS_CHECKOUT]

Runs four worker processes in the order other, this, this, other; each
imports its own checkout's ``src/`` and ``chip_smoke.py`` (so it runs as
a script, not with ``-m``) and, with that checkout's kernels built from
its sources, times

* the paged-attention wrapper at the main path's shapes (batch 8 of the
  smoke workload, L 1, 16, 64 and 256, qwen2-0.5b heads, bf16: the cases
  of ``chip_smoke.phase_timing``, from the same seed), and
* the flash-attention wrapper at ``chip_smoke.FLASH_GEOMS`` (S 4096,
  causal, bf16),

each beside one PyTorch call computing the same function
(scaled_dot_product_attention) and the least time the card could take.
Every row is one JSON line: CUDA-events ms around back-to-back wrapper
calls, and the kernel's own device ms from torch.profiler (the mean per
launch, so a trace that drops a launch record does not bias it).  The
card's name and power limit come first.  Needs one card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def kernel_ms(fn, iters, names):
    """Mean device ms per launch of the kernels whose names contain one of
    ``names``, summed over those kernels (each launches once per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and any(n in e.key for n in names)]
    return (sum(e.self_device_time_total / e.count for e in rows) / 1e3
            if rows else "not measured")


def worker(root: Path, label: str, run: int) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    tag = dict(checkout=label, run=run)
    n_layers = 24
    rng = np.random.default_rng(1)
    for L in (1, 16, 64, 256):
        if L == 1:
            ctx = [p + 16 + 1 for p in cs.PROMPT_LENS]
            start = [p + 16 for p in cs.PROMPT_LENS]
        else:
            ctx = [p + 1 for p in cs.PROMPT_LENS]
            start = [0] * len(cs.PROMPT_LENS)
        c = cs.make_case(rng, B=8, L=L, hd=64, Hq=14, kvh=2, stride=16,
                         s_max=512, dtype=torch.bfloat16, ctx=ctx,
                         start=start, holes=False, layers=n_layers)

        def kern(i, c=c):
            cs.run_rows(paged_attention_cuda, c, i % n_layers)

        libs = [cs.library_call(c, li) for li in range(n_layers)]
        bound, by = cs.bound(c, "bfloat16")
        print(json.dumps(dict(
            tag, kernel="paged_attention", L=L, B=8,
            ms=cs.cuda_ms(kern, 4 * n_layers),
            device_ms=kernel_ms(kern, n_layers, ("paged_",)),
            library_ms=cs.cuda_ms(lambda i: libs[i % n_layers](), n_layers),
            bound_ms=bound, bound_by=by)), flush=True)
    rng = np.random.default_rng(8)
    for label_g, B, Hq, Hkv, D in cs.FLASH_GEOMS:
        q, k, v = cs.flash_inputs(rng, B, Hq, Hkv, cs.FLASH_S, cs.FLASH_S, D,
                                  torch.bfloat16)
        kr = k.repeat_interleave(Hq // Hkv, dim=1)
        vr = v.repeat_interleave(Hq // Hkv, dim=1)
        bound, by = cs.flash_bound(B, Hq, Hkv, cs.FLASH_S, D, 2)
        print(json.dumps(dict(
            tag, kernel="flash_attention", geometry=label_g,
            ms=cs.cuda_ms(lambda i: flash_attention_cuda(q, k, v), 5),
            device_ms=kernel_ms(lambda i: flash_attention_cuda(q, k, v), 3,
                                ("flash_",)),
            library_ms=cs.cuda_ms(lambda i: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True), 5),
            bound_ms=bound, bound_by=by)), flush=True)
        del q, k, v, kr, vr
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
