#!/usr/bin/env python3
"""Check whether a garbage collection inside a step capture breaks it.

    PYTHONPATH=src python3 -m repro_torch.launch.capture_gc --collector off
    PYTHONPATH=src python3 -m repro_torch.launch.capture_gc --collector on

For reduced qwen2-0.5b and mamba2-780m in fp32 on one CUDA card, each of
``--rounds`` rounds serves four prompts on three engines, leaves each in a
reference cycle (so only a collection frees its graphs, pinned operands
and logits buffers), sets the collector's threshold to 1 (a collection at
nearly every allocation), and serves the prompts again on a fresh engine,
whose first steps capture their graphs.  ``--collector off`` runs the
port as it is (``core/hybrid.py::StepGraph`` keeps the collector off
while it warms up and captures a step); ``--collector on`` makes that
switch a no-op, so collections may run inside captures.  Each round is
one JSON line: whether every capture completed and the tokens equal an
engine built before, else the error.  The last line sums the rounds.
Needs one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import types

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import hybrid
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)


def card_engine(name):
    cfg = dataclasses.replace(reduced(get_config(name)),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    return build_engine(cfg, seed=0, engine_cfg=EngineConfig(
        s_max=64, buckets=(1, 2, 4), block_pos_stride=8,
        prefill_chunks=(16,), device="cuda"))


def one_round(name, ref, prompts, sampling, want):
    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            dead = card_engine(name)
            dead.params = ref.params
            generate(dead, prompts, sampling)
            dead.cycle = dead
            del dead
        gc.set_threshold(1, 1, 1)
        eng = card_engine(name)
        eng.params = ref.params
        got = [c.tokens for c in generate(eng, prompts, sampling)]
        return {"ok": got == want}
    except RuntimeError as e:
        return {"ok": False, "error": str(e)[:300],
                "cause": repr(e.__cause__)[:300]}
    finally:
        gc.set_threshold(*threshold)
        gc.collect()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--collector", choices=("on", "off"), default="off",
                    help="the collector during step captures")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("capture_gc: needs a CUDA card")
    if args.collector == "on":
        hybrid.gc = types.SimpleNamespace(
            isenabled=gc.isenabled, enable=gc.enable, disable=lambda: None)
    rng = np.random.default_rng(5)
    sampling = SamplingParams(max_tokens=6)
    n_ok = n = 0
    for name in ("qwen2-0.5b", "mamba2-780m"):
        ref = card_engine(name)
        prompts = [rng.integers(0, ref.cfg.vocab_size,
                                size=int(rng.integers(2, 30))).tolist()
                   for _ in range(4)]
        want = [c.tokens for c in generate(ref, prompts, sampling)]
        for r in range(args.rounds):
            row = {"arch": name, "round": r, "collector": args.collector,
                   **one_round(name, ref, prompts, sampling, want)}
            print(json.dumps(row), flush=True)
            n, n_ok = n + 1, n_ok + row["ok"]
        del ref
        gc.collect()
    print(json.dumps({"collector": args.collector, "rounds": n,
                      "ok": n_ok}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
