"""Dry run on one card: the FLOP, memory and roofline account of every
(arch x shape) cell, reckoned on the meta device, checked on the card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
      --memory-bytes <the card's> --jobs 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k                    # the card's name and memory
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m \\
      --shape prefill_32k --verify --batch 8

The counterpart of ``repro.launch.dryrun`` for one H100.  Each cell builds
what the JAX dry run lowers, on meta tensors (``init_params(device=
"meta")`` and :mod:`repro_torch.launch.specs`): ``train`` the full train
step (``make_train_step``, AdamW, the layer groups recomputed in the
backward), ``prefill`` ``make_prefill``, ``decode`` ``make_decode_step``
over a ``cache_specs`` cache (``batched``, ``longctx`` for ``long_500k``,
or ``--decode-mode gemv``: one function on one card).  It runs the step
under ``torch.utils.flop_counter.FlopCounterMode``, the grouped GEMM's
count (``kernels/grouped_mm/cost.py``: its ctypes launch is invisible to
the counter, so its meta route records the work) and the memory tracker
(:mod:`repro_torch.launch.memtrack`), at 2 and 3 layer groups
(:data:`COUNT_GROUPS`): the groups are identical, so every count at G
groups is the 2-group count plus (G - 2) times the difference, exactly
(the encoder of an encoder-decoder model scales with the decoder's
groups).  The FLOPs grow by the same amount from the first group on, but
the peak does not: with one group no layer sits between two others, and
the step's peak phase at 2 groups and more does not exist at 1; from 2
groups on the increments are equal (``tests/test_torch_dryrun.py`` holds
the extrapolation to a full-depth count).  A run at half the batch (2 for
a batch of 1) gives the slope in the batch, unless the resident state
alone (weights, moments, cache at batch 1) exceeds the memory.

Each cell writes one JSON to ``--out`` and prints one line: ``status``
(``ok``, or ``skipped`` with ``configs/shapes.py::applicable``'s reason),
``param_bytes``, ``flops`` (every aten FLOP the counter sees, recompute
included, and the grouped GEMM's part apart), ``peak_bytes`` at full depth
and the shape's batch, ``fits`` (at most ``FIT_SHARE`` of the memory, the
launchers' share), ``max_groups`` and ``max_layers`` at the shape's batch
(the depth where the peak reaches the share, beyond the config's depth
when it fits), ``max_batch`` at full depth, and two roofline terms at the
H100 SXM data-sheet peaks: the FLOPs at 989 (bf16) or 67 (fp32) TFLOP/s,
and the resident bytes (the weights and the cache or training state, read
once) at 3.35 TB/s.

The memory is the card's ``total_memory`` (``--device cuda``, the
default) or ``--memory-bytes`` (``--device cpu``; the figure chip_smoke.py's
``env`` phase prints for the card, PERF.md §4).  ``--verify`` (the card)
runs the cell's step for real, at the reckoned depth or ``--layers``,
``--batch`` cutting the batch: random weights from seed 0, a random batch,
the resident state in place, one warm-up step, then
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
(less what was allocated before the cell was built) and the synchronised
wall of one step.  It prints the reckoned and measured peaks and their
ratio, and the counted FLOPs over the wall.

There is no ``--mesh`` and no ``--strategy``: one card has no mesh (the
JAX dry run lowers on 256 or 512 TPU chips), and every tensor-parallel
strategy computes the same product on one card.  No collective is
counted: the emulated grid's wire bytes are ``core/shmem.py``'s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPE_BY_NAME, SHAPES, Shape, applicable
from repro_torch.device import resolve_device
from repro_torch.kernels.grouped_mm import cost
from repro_torch.launch import specs as sp
from repro_torch.launch.memtrack import MemTracker, tensors
from repro_torch.launch.train import FIT_SHARE
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import config_param_bytes, init_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.serve.decode import (cache_specs, make_decode_step,
                                      make_prefill)
from repro_torch.train.step import init_resid, make_train_step

# H100 SXM data sheet (the bounds chip_smoke.py uses)
ROOFLINE_CARD = "NVIDIA H100 SXM (data sheet)"
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# src/repro_torch/launch/dryrun.py -> the checkout's build/
DEFAULT_OUT = str(Path(__file__).resolve().parents[3] / "build"
                  / "dryrun_torch")
META = torch.device("meta")
# the layer groups each cell is counted at
COUNT_GROUPS = (2, 3)


@dataclasses.dataclass(frozen=True)
class Options:
    """What a cell runs besides its arch and shape."""
    decode_mode: Optional[str] = None      # None: the shape's (specs.py)
    grad_compress: bool = False
    moe_int8: bool = False
    state_bits: int = 32

    def tag(self) -> str:
        return ("__gc" if self.grad_compress else "") \
            + ("__int8a2a" if self.moe_int8 else "") \
            + (f"__{self.decode_mode}" if self.decode_mode else "") \
            + ("__s8" if self.state_bits == 8 else "")


def cell_config(arch: str, opts: Options) -> ModelConfig:
    cfg = get_config(arch)
    if opts.moe_int8:
        cfg = dataclasses.replace(cfg, moe_wire_dtype="int8")
    return cfg


def at_groups(cfg: ModelConfig, groups: int) -> ModelConfig:
    """``cfg`` cut (or grown) to ``groups`` layer groups; an encoder keeps
    its layers per decoder group."""
    kw: Dict[str, Any] = {"n_layers": groups * len(cfg.pattern())}
    if cfg.enc_layers:
        per, rest = divmod(cfg.enc_layers, cfg.n_groups())
        if rest:
            raise ValueError(f"{cfg.name}: {cfg.enc_layers} encoder layers "
                             f"over {cfg.n_groups()} decoder groups")
        kw["enc_layers"] = groups * per
    return dataclasses.replace(cfg, **kw)


def _real_batch(specs: Dict[str, torch.Tensor], cfg: ModelConfig,
                gen: torch.Generator, dev) -> Dict[str, torch.Tensor]:
    """Random tensors of the specs' shapes and dtypes on ``dev``."""
    out = {}
    for k, s in specs.items():
        if s.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            out[k] = torch.randn(s.shape, generator=gen, device=dev,
                                 dtype=s.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: Shape, batch: int, opts: Options,
               device=META) -> Tuple[Callable[[], Any], Tuple[Any, ...]]:
    """(run, resident): ``run()`` calls the cell's step once; ``resident``
    the trees it runs on (weights, optimizer state or cache, the batch).
    On the meta device nothing is drawn; elsewhere weights and inputs are
    random from seed 0."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)

    def inputs(specs):
        return specs if dev.type == "meta" else \
            _real_batch(specs, cfg, gen, dev)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_bits=opts.state_bits)
        opt = init_state(params, opt_cfg)
        if opts.grad_compress:
            opt["resid"] = init_resid(params)
        batch_t = inputs(sp.train_batch_specs(cfg, shape, batch))
        step = make_train_step(cfg, opt_cfg=opt_cfg, remat=True,
                               grad_compress=opts.grad_compress)
        return (lambda: step(params, opt, batch_t)), (params, opt, batch_t)
    if shape.kind == "prefill":
        batch_t = inputs(sp.prefill_batch_specs(cfg, shape, batch))
        step = make_prefill(cfg, extra_batch_keys=tuple(
            k for k in batch_t if k != "tokens"))
        return (lambda: step(params, batch_t)), (params, batch_t)
    mode = opts.decode_mode or sp.decode_mode(shape)
    step = make_decode_step(cfg, batch=batch, s_max=shape.seq_len, mode=mode)
    cache = cache_specs(cfg, batch, shape.seq_len, mode, device=dev)
    tokens = inputs({"tokens": sp.decode_token_specs(cfg, shape, batch)}
                    )["tokens"]
    pos = shape.seq_len - 1                # the last row of the cache
    return (lambda: step(params, cache, tokens, pos)), (params, cache, tokens)


def resident_bytes(cfg: ModelConfig, shape: Shape, batch: int,
                   opts: Options) -> int:
    """Bytes of a cell's resident trees on meta, without running it."""
    _, resident = build_cell(cfg, shape, batch, opts)
    seen = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for tree in resident for t in tensors(tree)}
    return sum(seen.values())


def count(arch: str, shape_name: str, batch: int, groups: int,
          opts: Options) -> Dict[str, Any]:
    """:func:`count_config` of a registry cell (the pool's unit of work:
    its arguments pickle)."""
    return count_config(cell_config(arch, opts), SHAPE_BY_NAME[shape_name],
                        batch, groups, opts)


def count_config(cfg: ModelConfig, shape: Shape, batch: int, groups: int,
                 opts: Options) -> Dict[str, Any]:
    """One run of a cell on meta at ``groups`` layer groups: aten FLOPs,
    the grouped GEMM's launches, FLOPs and bytes, the tracker's peak and
    resident bytes."""
    run, resident = build_cell(at_groups(cfg, groups), shape, batch, opts)
    # the counter enters last, so it sees every op before the tracker
    # (which may reuse a meta kernel's results, memtrack.py)
    layers._rope_freqs.cache_clear()    # made inside each count, as anew
    tracker = MemTracker(*resident)
    with tracker, cost.counting() as gmm, \
            FlopCounterMode(display=False) as fc:
        out = run()
        del out
    return {"aten_flops": fc.get_total_flops(), "gmm_flops": gmm.total_flops,
            "gmm_bytes": gmm.total_bytes,
            "gmm_launches": sum(gmm.launches.values()),
            "peak": tracker.peak, "resident": tracker.resident}


def _count_star(args):
    return count(*args)


def extrapolate(ra: Dict[str, int], rb: Dict[str, int], groups: int
                ) -> Dict[str, int]:
    """Every count at ``groups`` from its values at :data:`COUNT_GROUPS`."""
    a, b = COUNT_GROUPS
    return {k: ra[k] + (groups - a) * (rb[k] - ra[k]) // (b - a)
            for k in ra}


def max_groups(ra: Dict[str, int], rb: Dict[str, int], limit: float) -> int:
    """The most layer groups whose extrapolated peak is within ``limit``
    (the line read backwards to 1 group: an estimate there, see the
    module docstring)."""
    step = (rb["peak"] - ra["peak"]) // (COUNT_GROUPS[1] - COUNT_GROUPS[0])
    if step <= 0:
        return 1 << 30
    one = ra["peak"] - (COUNT_GROUPS[0] - 1) * step
    return max(0, int((limit - one) // step) + 1)


def half_batch(batch: int) -> int:
    return batch // 2 if batch > 1 else 2


def cell_runs(arch: str, shape: Shape, opts: Options, limit: float
              ) -> List[Tuple]:
    """The :func:`count` runs a cell needs: :data:`COUNT_GROUPS` at its
    batch, and at :func:`half_batch` unless the resident state at batch 1
    and full depth already exceeds ``limit`` (then no batch fits)."""
    B = shape.global_batch
    runs = [(arch, shape.name, B, g, opts) for g in COUNT_GROUPS]
    if resident_bytes(cell_config(arch, opts), shape, 1, opts) <= limit:
        runs += [(arch, shape.name, half_batch(B), g, opts)
                 for g in COUNT_GROUPS]
    return runs


def report(arch: str, shape: Shape, opts: Options, memory: int,
           device_name: str, results: Dict[Tuple, Dict[str, int]]
           ) -> Dict[str, Any]:
    """The cell's report from its runs' results (keyed by run)."""
    cfg = cell_config(arch, opts)
    G, plen, B = cfg.n_groups(), len(cfg.pattern()), shape.global_batch
    limit = FIT_SHARE * memory
    r1, r2 = (results[(arch, shape.name, B, g, opts)] for g in COUNT_GROUPS)
    full = extrapolate(r1, r2, G)
    flops = full["aten_flops"] + full["gmm_flops"]
    mg = max_groups(r1, r2, limit)
    B2 = half_batch(B)
    half = [results.get((arch, shape.name, B2, g, opts))
            for g in COUNT_GROUPS]
    if half[0] is None:
        mb = 0                             # the resident state alone
    else:
        p2 = extrapolate(half[0], half[1], G)["peak"]
        slope = (full["peak"] - p2) / (B - B2)
        mb = max(0, int(B + (limit - full["peak"]) // slope)) \
            if slope > 0 else 1 << 30
    compute_s = flops / PEAK_FLOPS[cfg.compute_dtype]
    memory_s = full["resident"] / HBM_BYTES_S
    return {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "status": "ok", "options": dataclasses.asdict(opts),
        "decode_mode": (opts.decode_mode or sp.decode_mode(shape))
        if shape.kind in ("decode", "long_decode") else None,
        "n_layers": cfg.n_layers, "groups": G, "batch": B,
        "seq_len": shape.seq_len, "device": device_name,
        "memory_bytes": memory, "fit_share": FIT_SHARE,
        "param_bytes": config_param_bytes(cfg),
        "resident_bytes": full["resident"],
        "flops": flops, "aten_flops": full["aten_flops"],
        "grouped_mm": {"flops": full["gmm_flops"],
                       "bytes": full["gmm_bytes"],
                       "launches": full["gmm_launches"]},
        "peak_bytes": full["peak"], "fits": full["peak"] <= limit,
        "max_groups": mg, "max_layers": mg * plen, "max_batch": mb,
        "roofline": {
            "card": ROOFLINE_CARD, "peak_flops": PEAK_FLOPS[
                cfg.compute_dtype], "hbm_bytes_s": HBM_BYTES_S,
            "compute_s": compute_s, "memory_s": memory_s,
            "bound_by": "operations" if compute_s >= memory_s
            else "bytes"},
        "counted_at": {"groups": list(COUNT_GROUPS),
                       "batch": [B, B2] if half[0] else [B]},
    }


def skipped(arch: str, shape: Shape, opts: Options, reason: str
            ) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "status": "skipped", "reason": reason,
            "options": dataclasses.asdict(opts)}


def run_cells(cells: List[Tuple[str, Shape]], opts: Options, memory: int,
              device_name: str, jobs: int = 1) -> List[Dict[str, Any]]:
    """Every cell's report; the counting runs spread over ``jobs``
    spawned processes (each one imports torch and warms its meta kernels
    once), the longest first."""
    limit = FIT_SHARE * memory
    reports: Dict[int, Dict[str, Any]] = {}
    runs: List[Tuple] = []
    for i, (arch, shape) in enumerate(cells):
        ok, reason = applicable(cell_config(arch, opts), shape)
        if ok:
            runs += cell_runs(arch, shape, opts, limit)
        else:
            reports[i] = skipped(arch, shape, opts, reason)
    runs.sort(key=lambda r: -_weight(r))
    if jobs > 1 and len(runs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(jobs, len(runs))) as pool:
            counted = pool.map(_count_star, runs, chunksize=1)
    else:
        counted = [count(*r) for r in runs]
    results = dict(zip(runs, counted))
    for i, (arch, shape) in enumerate(cells):
        if i not in reports:
            reports[i] = report(arch, shape, opts, memory, device_name,
                                results)
    return [reports[i] for i in range(len(cells))]


def _weight(run: Tuple) -> int:
    """A run's rough cost on meta, for the order of the pool: its layers,
    times its parameters' share of the optimizer's slices when it
    trains."""
    arch, shape_name, _, groups, opts = run
    cfg = at_groups(cell_config(arch, opts), groups)
    w = cfg.n_layers * (2 if SHAPE_BY_NAME[shape_name].kind == "train"
                        else 1)
    if SHAPE_BY_NAME[shape_name].kind == "train":
        w += config_param_bytes(cfg) >> 26
    return w


def line(rep: Dict[str, Any], tag: str) -> str:
    if rep["status"] != "ok":
        return f"[{rep['status']}] {tag} ({rep.get('reason', '')})"
    rf = rep["roofline"]
    return (f"[ok] {tag} flops={rep['flops']:.4g} "
            f"(grouped_mm {rep['grouped_mm']['flops']:.3g}) "
            f"peak={rep['peak_bytes'] / 1e9:.2f}GB fits={rep['fits']} "
            f"max_layers={rep['max_layers']} max_batch={rep['max_batch']} "
            f"compute={rf['compute_s'] * 1e3:.4g}ms "
            f"memory={rf['memory_s'] * 1e3:.4g}ms ({rf['card']})")


# ---------------------------------------------------------------------------
# --verify: the cell's step on the card.
# ---------------------------------------------------------------------------

def verify_cell(arch: str, shape_name: str, opts: Options, *,
                layers: Optional[int] = None, batch: Optional[int] = None,
                device=None) -> Dict[str, Any]:
    """Reckon the cell at its verify depth and batch on meta, then run it
    on the card and measure its peak and wall (module docstring)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("--verify measures on the card")
    shape = SHAPE_BY_NAME[shape_name]
    cfg = cell_config(arch, opts)
    ok, reason = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} {shape_name}: {reason}")
    plen = len(cfg.pattern())
    B = batch or shape.global_batch
    memory = torch.cuda.get_device_properties(dev).total_memory
    r1, r2 = (count(arch, shape_name, B, g, opts) for g in COUNT_GROUPS)
    if layers is None:
        groups = min(cfg.n_groups(),
                     max_groups(r1, r2, FIT_SHARE * memory))
    else:
        if layers < 1 or layers % plen:
            raise ValueError(f"--layers {layers} is not a positive multiple "
                             f"of {cfg.name}'s pattern of {plen}")
        groups = layers // plen
    if groups < 1:
        raise MemoryError(f"{arch} {shape_name}: no layer group fits at "
                          f"batch {B}")
    want = extrapolate(r1, r2, groups)
    if want["peak"] > FIT_SHARE * memory:
        raise MemoryError(f"{arch} {shape_name} at {groups * plen} layers "
                          f"and batch {B} reckons {want['peak'] / 1e9:.1f} "
                          f"GB, more than {FIT_SHARE:.0%} of the card's "
                          f"{memory / 1e9:.1f} GB: cut --layers or --batch")
    flops = want["aten_flops"] + want["gmm_flops"]

    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    run, resident = build_cell(at_groups(cfg, groups), shape, B, opts,
                               device=dev)
    warm = run()                            # the warm-up step
    del warm, resident
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated(dev) - base
    del out, run
    torch.cuda.empty_cache()
    peak = PEAK_FLOPS[cfg.compute_dtype]
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "options": dataclasses.asdict(opts),
        "device": torch.cuda.get_device_name(dev), "memory_bytes": memory,
        "layers": groups * plen, "of_layers": cfg.n_layers, "batch": B,
        "batch_cut": B != shape.global_batch,
        "reckoned_peak_bytes": want["peak"], "measured_peak_bytes": measured,
        "peak_ratio": measured / want["peak"],
        "flops": flops, "grouped_mm_launches": want["gmm_launches"],
        "wall_s": wall, "tflops_s": flops / wall / 1e12,
        "peak_tflops_s": peak / 1e12,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--decode-mode", default=None, choices=["gemv"])
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--moe-int8", action="store_true")
    ap.add_argument("--state-bits", type=int, default=32, choices=[32, 8])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the card (default) for its name and memory; cpu "
                         "takes the memory from --memory-bytes")
    ap.add_argument("--memory-bytes", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=len(os.sched_getaffinity(0)),
                    help="processes that count the cells (default: the "
                         "CPUs this process may use)")
    ap.add_argument("--verify", action="store_true",
                    help="run the cell's step on the card and measure it")
    ap.add_argument("--layers", type=int, default=None,
                    help="--verify: the depth (default: the reckoned one)")
    ap.add_argument("--batch", type=int, default=None,
                    help="--verify: cut the batch")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    opts = Options(args.decode_mode, args.grad_compress, args.moe_int8,
                   args.state_bits)

    dev = resolve_device(args.device)
    if args.verify:
        if not (args.arch and args.shape):
            ap.error("--verify takes one cell: --arch and --shape")
        print(json.dumps(verify_cell(args.arch, args.shape, opts,
                                     layers=args.layers, batch=args.batch,
                                     device=dev)), flush=True)
        return
    if dev.type == "cuda":
        memory = torch.cuda.get_device_properties(dev).total_memory
        name = torch.cuda.get_device_name(dev)
    elif args.memory_bytes is None:
        ap.error("--device cpu needs --memory-bytes (the card's memory)")
    else:
        memory, name = args.memory_bytes, "cpu (--memory-bytes)"
    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, SHAPE_BY_NAME[args.shape])]
    else:
        ap.error("give --all, or --arch and --shape")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    for rep in run_cells(cells, opts, memory, name, args.jobs):
        tag = f"{rep['arch']}__{rep['shape']}{opts.tag()}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rep, f, indent=1)
        print(line(rep, tag), flush=True)
    print(json.dumps({"cells": len(cells), "out": args.out,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
