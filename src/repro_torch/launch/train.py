"""Training launcher: ``--arch <id>`` end to end with fault tolerance, on
the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --full
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --full
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --full --layers 2 --state-bits 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
      --full --seq-len 448
  PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \\
      --full --layers 12 --seq-len 2048 --global-batch 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --device cpu --steps 20          # the reduced config, on the CPU

trains any family (dense, MoE, SSM, hybrid; whisper-base's encoder and
decoder on stub frames; pixtral-12b's decoder on projected stub patch
embeddings) with AdamW on batches of the deterministic synthetic
pipeline, random weights from seed 0, the layer groups recomputed in
the backward.  Without ``--full`` it takes the ``reduced()`` config, as
the JAX launcher does; ``--full`` takes the full config, and ``--layers``
cuts its depth where one card cannot hold it.  The device is the card
unless ``--device cpu``; with no card and no ``--device cpu`` it raises.
On one card ``--strategy`` changes nothing: every tensor-parallel
strategy of the JAX launcher computes the same product there.  With
``--grid QxR`` the steps run on a ``q x r`` grid of PE processes
(``launch/grid_run.py``; the backward through the grid's puts and
collectives), each PE on its blocks of the seed-0 weights in the storage
of ``--strategy`` (cannon_opt by default, as the JAX launcher), PE 0
logging; there ``grad_norm`` is the JAX grid step's, q*r times the
model's (ROADMAP section 3).  Every PE runs the training controller:
checkpoints, resume and the fault drill work on a grid as on one card,
each checkpoint in the stored form of the q x r grid
(``ckpt/checkpoint.py::save_grid_state``, written by every PE), which the
1x1 port also reads (with fp32 moments).  A grid run that stops past its
retry budget exits non-zero once every PE has reported:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --grid 2x2 --device cpu --steps 2          # the reduced config
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --full --grid 2x2 --seq-len 1024 --global-batch 2 --steps 4

Before it allocates, it reckons the parameter, gradient and moment (and
with ``--grad-compress`` residual) bytes from the config and raises
``MemoryError`` naming the device's memory when they take more than
``FIT_SHARE`` of it: qwen3-moe-235b-a22b at 2 of its 94 layers needs 8-bit
moments (``--state-bits 8``, 37 GB; with fp32 moments 74 GB).

Every ``--ckpt-every`` steps it writes a checkpoint in the JAX package's
stored form to ``--ckpt-dir`` and, started again, resumes from the latest
one there.  ``--fail-at-step N`` is a fault drill: step N raises
``TransientWorkerFailure`` on every attempt, so the run stops past its
retry budget, as a preempted worker would; run again without it to
resume.  ``--deterministic`` sets ``torch.use_deterministic_algorithms``
(and the cuBLAS workspace it needs), so a resumed run repeats the losses
of an uninterrupted one bit for bit.  Each logged step prints one JSON
line (step, loss, grad_norm, lr, seconds); the run ends with one JSON
summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TP_STRATEGIES
from repro_torch.models.params import init_params, param_leaves
from repro_torch.optim.adamw import QBLOCK, AdamWConfig, init_state
from repro_torch.runtime.fault_tolerance import (DEFAULT_CKPT_DIR,
                                                 FaultConfig, TrainController,
                                                 TransientWorkerFailure)
from repro_torch.train.step import init_resid, make_train_step

# share of the device's memory the training state may take; the rest holds
# the activations of one step (remat keeps them to a layer group's)
FIT_SHARE = 0.9


def train_config(arch: str, full: bool = False,
                 layers: Optional[int] = None) -> ModelConfig:
    """The config a run trains: full or reduced, its depth cut to
    ``layers`` (a multiple of the layer pattern's length)."""
    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    if layers is not None:
        plen = len(cfg.pattern())
        if layers < 1 or layers % plen:
            raise ValueError(f"--layers {layers} is not a positive multiple "
                             f"of {cfg.name}'s pattern of {plen}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _leaf_sizes(cfg: ModelConfig):
    """(elements, bytes an element) of every parameter leaf."""
    return [(math.prod(shape), torch.empty((), dtype=dt).element_size())
            for shape, dt in param_leaves(cfg)]


def train_state_bytes(cfg: ModelConfig, state_bits: int = 32,
                      grad_compress: bool = False) -> Dict[str, int]:
    """Bytes of the training state, reckoned from the config: parameters,
    gradients (the parameters' dtypes), the two moments (fp32, or int8
    codes and an fp32 scale per block of 128) and the compression
    residuals (bf16)."""
    sizes = _leaf_sizes(cfg)
    params = sum(n * e for n, e in sizes)
    if state_bits == 8:
        moments = 2 * sum(-(-n // QBLOCK) * (QBLOCK + 4) for n, _ in sizes)
    else:
        moments = 2 * 4 * sum(n for n, _ in sizes)
    out = {"params": params, "grads": params, "moments": moments,
           "resid": 2 * sum(n for n, _ in sizes) if grad_compress else 0}
    out["total"] = sum(out.values())
    return out


def check_fit(cfg: ModelConfig, device, state_bits: int = 32,
              grad_compress: bool = False) -> Dict[str, int]:
    """:func:`train_state_bytes`; raises ``MemoryError`` naming the
    device's memory when the total takes more than ``FIT_SHARE`` of it."""
    need = train_state_bytes(cfg, state_bits, grad_compress)
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        have, where = props.total_memory, f"{props.name}'s"
    else:
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = "the host's"
    if need["total"] > FIT_SHARE * have:
        raise MemoryError(
            f"{cfg.name} at {cfg.n_layers} layers needs "
            f"{need['total'] / 1e9:.1f} GB of training state (parameters "
            f"{need['params'] / 1e9:.1f}, gradients "
            f"{need['grads'] / 1e9:.1f}, {state_bits}-bit moments "
            f"{need['moments'] / 1e9:.1f}), more than {FIT_SHARE:.0%} of "
            f"{where} {have / 1e9:.1f} GB: cut the depth (--layers), take "
            f"8-bit moments (--state-bits 8) or the reduced config")
    return need


def data_config(cfg: ModelConfig, seq_len: int, global_batch: int,
                full: bool) -> DataConfig:
    """The JAX launcher's batches: at the config's vocab with ``--full``,
    at most 256 token ids otherwise; whisper's carry ``enc_seq`` stub
    frames at d_model, pixtral's ``vis_patches`` patch embeddings at
    d_model in front of ``seq_len - vis_patches`` text tokens."""
    vocab = cfg.vocab_size if full else min(cfg.vocab_size, 256)
    kw = {}
    if cfg.enc_layers:
        kw.update(frames=cfg.enc_seq, frame_dim=cfg.d_model)
    if cfg.vis_patches:
        if seq_len <= cfg.vis_patches:
            raise ValueError(f"--seq-len {seq_len} leaves no text after "
                             f"{cfg.name}'s {cfg.vis_patches} patches")
        kw.update(patches=cfg.vis_patches, patch_dim=cfg.d_model)
        seq_len -= cfg.vis_patches
    return DataConfig(vocab_size=vocab, seq_len=seq_len,
                      global_batch=global_batch, **kw)


def setup(cfg: ModelConfig, *, device, opt_cfg: AdamWConfig,
          grad_compress: bool = False) -> Tuple[Dict, Dict, object]:
    """(params, opt_state, step_fn) on ``device``: random weights from
    seed 0, zero moments (and residuals), the step with the layer
    groups recomputed in the backward."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    opt_state = init_state(params, opt_cfg)
    if grad_compress:
        opt_state["resid"] = init_resid(params)
    step_fn = make_train_step(cfg, opt_cfg=opt_cfg, remat=True,
                              grad_compress=grad_compress)
    return params, opt_state, step_fn


def device_batch(dc: DataConfig, step: int, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch(dc, step, 0, 1).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the full config instead of the reduced one")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    ap.add_argument("--state-bits", type=int, default=32, choices=[32, 8])
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N steps (0: none)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="fault drill: step N fails on every attempt")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the card (raises when there is none)")
    ap.add_argument("--grid", default=None,
                    help="QxR: train on a grid of PE processes")
    ap.add_argument("--strategy", default="cannon_opt",
                    choices=list(TP_STRATEGIES),
                    help="the grid's distributed GEMM (default cannon_opt, "
                         "as the JAX launcher's)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.grid:
        return _main_grid(args)
    if args.deterministic:
        # cuBLAS needs a fixed workspace for reproducible products
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    dev = resolve_device(args.device)
    cfg = train_config(args.arch, args.full, args.layers)
    need = check_fit(cfg, dev, args.state_bits, args.grad_compress)
    print(json.dumps({"config": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "device": str(dev),
                      "state_gb": {k: round(v / 1e9, 3)
                                   for k, v in need.items()}}), flush=True)
    dc = data_config(cfg, args.seq_len, args.global_batch, args.full)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          decay_steps=max(args.steps, 100),
                          state_bits=args.state_bits)
    params, opt_state, step_fn = setup(cfg, device=dev, opt_cfg=opt_cfg,
                                       grad_compress=args.grad_compress)

    def injector(step):
        if step == args.fail_at_step:
            raise TransientWorkerFailure(f"fault drill at step {step}")

    fcfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       fail_injector=injector
                       if args.fail_at_step is not None else None)

    def logged_step(p, o, b):
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, b)
        step = int(o["step"]) - 1
        if step % args.log_every == 0 or step == args.steps - 1:
            print(json.dumps({
                "step": step, "loss": float(m["loss"]),
                "ce_loss": float(m["ce_loss"]),
                "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                "seconds": time.perf_counter() - t0}), flush=True)
        return p, o, m

    ctrl = TrainController(logged_step,
                           lambda s: device_batch(dc, s, dev), fcfg,
                           cfg=cfg, device=dev)
    start, params, opt_state = ctrl.resume_or_init(params, opt_state)
    t0 = time.perf_counter()
    params, opt_state = ctrl.run(params, opt_state, args.steps, start)
    print(json.dumps({"done": len(ctrl.metrics_log), "start_step": start,
                      "retries": ctrl.retries, "skipped": ctrl.skipped,
                      "seconds": time.perf_counter() - t0,
                      "losses": ctrl.metrics_log}), flush=True)


def _main_grid(args) -> None:
    """``--grid QxR``: the steps on a grid of PE processes
    (``launch/grid_run.py::TrainJob``; PE p on ``cuda:{p % count}`` or
    the CPU), every PE on its blocks of the seed-0 weights in the
    strategy's storage and on the same batches, under the training
    controller (checkpoints, resume, the fault drill); PE 0 logs."""
    from repro_torch.launch.grid_run import TrainJob, run_on_grid
    from repro_torch.partition import parse_grid
    if args.deterministic:
        # the PEs inherit it; each runs under deterministic algorithms
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    plan = parse_grid(args.grid)
    device = args.device or "cuda"
    cfg = train_config(args.arch, args.full, args.layers)
    if cfg.enc_layers or cfg.vis_patches:
        raise SystemExit(f"{cfg.name}: encoder and vision families on a grid "
                         f"of PE processes come with a later slice")
    need = check_fit(cfg, resolve_device(device), args.state_bits,
                     args.grad_compress)
    print(json.dumps({"config": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "device": device,
                      "grid": f"{plan.grid_q}x{plan.grid_r}",
                      "strategy": args.strategy,
                      "state_gb": {k: round(v / 1e9, 3)
                                   for k, v in need.items()}}), flush=True)
    dc = data_config(cfg, args.seq_len, args.global_batch, args.full)
    opt = dict(lr=args.lr, warmup_steps=10,
               decay_steps=max(args.steps, 100), state_bits=args.state_bits)
    job = TrainJob(cfg, args.strategy, data=dc, steps=args.steps, seed=0,
                   opt=opt, grad_compress=args.grad_compress,
                   log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every,
                   fail_at_step=args.fail_at_step,
                   deterministic=args.deterministic)
    t0 = time.perf_counter()
    reports = run_on_grid([job], plan, device=device)[0]
    pe0 = reports[0]

    def launches(r):
        return [{k: c["launches"] for k, c in s["launches"].items()}
                for s in r["steps"]]

    same = all([s["loss"] for s in r["steps"]]
               == [s["loss"] for s in pe0["steps"]] for r in reports)
    same_launches = all(launches(r) == launches(pe0) for r in reports)
    heap = {s["heap_bytes"] for r in reports for s in r["steps"]}
    print(json.dumps({
        "done": len(pe0["steps"]), "seconds": time.perf_counter() - t0,
        "start_step": pe0["start_step"], "retries": pe0["retries"],
        "skipped": pe0["skipped"], "stopped_at": pe0["stopped_at"],
        "checkpoints": pe0["checkpoints"], "restored": pe0["restored"],
        "ckpt_step": pe0["ckpt_step"],
        "steps": [s["step"] for s in pe0["steps"]],
        "losses": [s["loss"] for s in pe0["steps"]],
        "grad_norms": [s["grad_norm"] for s in pe0["steps"]],
        "ms_per_step": [1e3 * s["wall_s"] for s in pe0["steps"]],
        "collectives_per_step": [s["collectives"] for s in pe0["steps"]],
        "reckoned_collectives": pe0["reckoned_collectives"],
        "heap_bytes_per_pe": sorted(heap),
        "reckoned_heap_bytes": pe0["reckoned_heap_bytes"],
        "launches_per_step": launches(pe0),
        "reckoned_heap_launches": pe0["reckoned_heap_launches"],
        "losses_equal_on_every_pe": same,
        "launches_equal_on_every_pe": same_launches}), flush=True)
    if not same or not same_launches \
            or heap - {pe0["reckoned_heap_bytes"]}:
        raise SystemExit("the grid's steps differ across PEs or from their "
                         "reckoning")
    if pe0["stopped_at"] is not None:
        raise SystemExit(
            f"the grid run stopped at step {pe0['stopped_at']} past its "
            f"retry budget ({pe0['retries']} retries); its latest "
            f"checkpoint is step {pe0['ckpt_step']} in {args.ckpt_dir}: run "
            f"again to resume")


if __name__ == "__main__":
    main()
