#!/usr/bin/env python3
"""Serve two checkouts' engines on one CUDA card, in turns.

    python3 src/repro_torch/launch/compare_engine.py OTHER_CHECKOUT \
        [THIS_CHECKOUT]

Runs four worker processes in the order other, this, this, other; each
imports its own checkout's ``src/`` (kernels built from its sources) and
serves qwen2-0.5b and then mamba2-780m at full width (random weights from
seed 0) through this checkout's ``chip_smoke.py`` engine setting and
workload: ``s_max`` 512, buckets 1-8, stride 16, chunk ladder 16/64/256,
prompt lengths ``PROMPT_LENS``, 32 greedy tokens; served cold, warm
through the prefix caches, then as one-per-step arrivals.  Each worker
prints, per model, one JSON row with

* the warm pass's tokens/s (``throughput_tok_s``) and mean TTFT, and the
  cold and arrival passes' as well;
* eight batch-8 decode steps under torch.profiler (``phase_profile``) and
  one batch-8 len256 chunked-prefill step (``phase_prefill_profile``):
  host wall ms, device busy ms, device idle share, kernels launched, and
  the prefill step's SSD kernels' ms (``ssd_ms``);
* the steps its queue built (``n_executables``) and their build seconds
  (``KernelEvent.build_time_s``; 0 where the checkout's queue has none);

and one row with each pass's greedy tokens.  After the four runs a
summary row says whether every run gave the same tokens.  The card's name
and power limit come first.  Needs one card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

THIS = Path(__file__).resolve().parents[3]
ARCHS = ("qwen2-0.5b", "mamba2-780m")


def serve(cs, arch):
    """One model through the smoke's passes and profiles: (row, tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, SamplingParams
    cfg = get_config(arch)
    gen = torch.Generator("cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    eng = cs.checking_engine()(cfg, params=params, engine_cfg=EngineConfig(
        s_max=512, buckets=(1, 2, 4, 8), block_pos_stride=16,
        prefill_chunks=(16, 64, 256), device="cuda"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in cs.PROMPT_LENS]
    arrivals = [rng.integers(0, cfg.vocab_size, n).tolist()
                for n in cs.PROMPT_LENS]
    sampling = SamplingParams(max_tokens=cs.MAX_TOKENS)
    passes, _, _, outputs = cs.serve_passes(eng, cfg, prompts, arrivals,
                                            sampling)
    events = eng.kernel_events()
    built = dict(n_executables=eng.queue.n_executables,
                 build_s=sum(getattr(ev, "build_time_s", 0.0)
                             for ev in events.values()))
    decode = cs.phase_profile(eng, arrivals, sampling)
    prefill = cs.phase_prefill_profile(eng)
    shares = prefill["kernel_shares"]
    keys = ("step_wall_ms", "device_busy_ms", "device_idle_share")
    row = dict(config=arch, **{
        f"{label}_{k}": passes[label][k] for label in passes
        for k in ("tokens_per_s", "mean_ttft_ms", "wall_s")},
        decode={k: decode[k] for k in keys + ("kernels_per_step",)},
        prefill=dict({k: prefill[k] for k in keys + ("kernels",)},
                     ssd_ms=shares["ssd"]["ms"] if isinstance(shares, dict)
                     else shares),
        **built)
    tokens = {label: out[0] for label, out in outputs.items()}
    del eng, params
    torch.cuda.empty_cache()
    return row, tokens


def worker(root: Path, label: str, run: int) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  THIS / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ARCHS:
        row, tokens = serve(cs, arch)
        print(json.dumps(dict(checkout=label, run=run, **row)), flush=True)
        print(json.dumps(dict(checkout=label, run=run, config=arch,
                              tokens=tokens)), flush=True)


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
    tokens = {arch: [] for arch in ARCHS}
    for run, (root, label) in enumerate(((other, "other"), (this, "this"),
                                         (this, "this"), (other, "other"))):
        res = subprocess.run([sys.executable, __file__, "--worker",
                              str(root), label, str(run)],
                             capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(res.stdout, flush=True)
            raise SystemExit(f"worker {run} ({label}) failed: "
                             f"{res.returncode}")
        for line in res.stdout.splitlines():
            if '"tokens": {' in line:
                row = json.loads(line)
                tokens[row["config"]].append(row["tokens"])
            elif '"phase": "engine_pass"' not in line:
                print(line, flush=True)
    print(json.dumps({"tokens_equal_across_runs": {
        arch: all(t == ts[0] for t in ts) for arch, ts in tokens.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
