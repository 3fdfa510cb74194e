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
There is no ``--strategy``: on one card every tensor-parallel strategy of
the JAX launcher computes the same product.

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
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="fault drill: step N fails on every attempt")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the card (raises when there is none)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
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


if __name__ == "__main__":
    main()
