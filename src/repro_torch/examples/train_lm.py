"""End-to-end example: train a ~100M-parameter dense LM on one card under
the fault-tolerant controller, with checkpoint / resume and the loss
trajectory.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
      --d-model 64 --layers 2 --vocab 512 --seq 32 --steps 20

The counterpart of the JAX package's ``examples/train_lm.py`` (there on a
16-PE grid with the Cannon-opt strategy; on one card every strategy is
the same product).  The model is d_model 512, 8 layers, 8 q over 4 kv
heads with qk-norm, d_ff 2048, vocab 32768 in fp32: about 100M
parameters.  Batches come from the deterministic synthetic pipeline,
AdamW (peak lr 3e-4) warms up over 30 steps and decays over the run, the layer groups
are recomputed in the backward, and a checkpoint (the JAX package's
stored training form) is written every ``--ckpt-every`` steps to
``--ckpt``: a second run with the same directory resumes from its latest
checkpoint.  ``--fail-at-step N`` is a fault drill, as in
``launch/train.py``: step N fails on every attempt, so the run stops past
its retry budget; run again without it to resume.  It fails if the loss
does not fall.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import torch

from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import device_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, param_bytes
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.fault_tolerance import (FaultConfig, TrainController,
                                                 TransientWorkerFailure)
from repro_torch.train.step import make_train_step

# src/repro_torch/examples/train_lm.py -> the checkout's build/
DEFAULT_CKPT = str(Path(__file__).resolve().parents[3] / "build"
                   / "example_ckpt")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="fault drill: step N fails on every attempt")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params at these dims (d=512, L=8, ff=2048, V=32768)
    cfg = ModelConfig(
        name="lm100m", family="dense", d_model=args.d_model,
        n_layers=args.layers, n_heads=8, n_kv_heads=4,
        d_ff=4 * args.d_model, vocab_size=args.vocab, qk_norm=True,
        rope_theta=1e4, param_dtype=torch.float32,
        compute_dtype=torch.float32, attn_block_kv=128)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          decay_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg=opt_cfg, remat=True)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    print(f"params: {param_bytes(params) / 4 / 1e6:.1f}M (fp32) on {dev}")
    opt_state = init_state(params, opt_cfg)

    dc = DataConfig(vocab_size=args.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    def injector(step):
        if step == args.fail_at_step:
            raise TransientWorkerFailure(f"fault drill at step {step}")

    ctrl = TrainController(step_fn, lambda s: device_batch(dc, s, dev),
                           FaultConfig(ckpt_dir=args.ckpt,
                                       ckpt_every=args.ckpt_every,
                                       fail_injector=injector),
                           cfg=cfg, device=dev)
    start, params, opt_state = ctrl.resume_or_init(params, opt_state)
    if start:
        print(f"resumed from {args.ckpt} at step {start}")
    params, opt_state = ctrl.run(params, opt_state, args.steps, start)
    losses = [loss for _, loss in ctrl.metrics_log]
    k = max(len(losses) // 10, 1)
    print("loss trajectory:",
          [round(sum(losses[i:i + k]) / len(losses[i:i + k]), 3)
           for i in range(0, len(losses), k)])
    if len(losses) > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses[0]} -> "
                         f"{losses[-1]}")
    print("OK")
    return {"start": start, "losses": ctrl.metrics_log, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
