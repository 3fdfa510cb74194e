"""Forward and fixed-batch decode jobs on a grid of PE processes.

The blocked layout of the JAX package on ``q x r`` PE processes
(:func:`repro_torch.runtime.pe.run_pes`): every PE cuts its blocks of one
global set of weights in the storage its strategy reads
(``shard_params(..., storage=)``) and runs

  * a :class:`ForwardJob`: ``make_loss_fn`` and ``make_prefill`` on a
    (B, S) batch under one ``tp_strategy`` (cannon, cannon_opt, allgather
    or SUMMA; :func:`repro_torch.train.step.make_pctx`), each ``runs``
    times;
  * a :class:`DecodeJob`: ``make_decode_step(mode="batched")``, greedy
    tokens from one token a row, as the JAX launcher decodes;
  * a :class:`TrainJob`: AdamW steps of ``make_train_step`` with a grid
    ``pctx``, the backward through the grid's puts and collectives, run
    by the training controller on every PE (checkpoints in the grid's
    stored form, resume, the retry and skip rules, the fault drill).

Every job of a run shares one spawn of the grid; each sizes its own heap
from :func:`blocked_messages` (its largest message) and frees it after.
A run may also hold the serving engine's jobs
(``serve/engine/grid.py::GridJob``, served as ``serve_on_grid`` serves
them) and probes (:class:`ProbeJob`), so one spawn pays the PEs' start
for all of them.
Weights drawn from a seed are drawn once for consecutive jobs of one
model: each PE keeps the global tree and cuts each job's storage from it.
Each PE reports its results (loss, last-position logits, tokens, logits
rows), and per forward or decode step its wall, collectives, puts, heap
bytes, barrier wait and kernel launches (by variant).
:func:`blocked_messages` reckons from the shapes alone every message a
forward or a decode step puts into the heaps, and :func:`train_messages`
every message of a training step (forward, recompute, backward and the
gradient reduction), which the heap bytes a PE counts must equal.

    PYTHONPATH=src python -m repro_torch.launch.grid_run --arch qwen2-0.5b \\
        --smoke --device cpu                  # every strategy, then decode
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import latest_step as ckpt_latest
from repro_torch.kernels import count_delta, launch_counts
from repro_torch.models.config import pad_to_multiple
from repro_torch.models.layers import TP_STRATEGIES
from repro_torch.models.moe import moe_capacity
from repro_torch.models.params import (init_params, shard_params,
                                       storage_for)
from repro_torch.serve.decode import (Message, cache_specs, make_decode_step,
                                      make_prefill)
from repro_torch.serve.engine.grid import GridJob, grid_serve_pe, pe_params
from repro_torch.train.step import make_loss_fn, make_pctx


@dataclasses.dataclass
class ForwardJob:
    """The loss and the prefill of one (B, S) batch under ``strategy``.
    ``weights``: a global numpy tree (``from_jax_params`` takes it), else
    drawn from ``seed`` on every PE's device as one device draws them."""
    cfg: Any
    strategy: str
    tokens: np.ndarray                # (B, S) int
    labels: np.ndarray                # (B, S) int, -100 masked
    seed: int = 0
    weights: Optional[Dict] = None
    runs: int = 1                     # times each of loss and prefill runs


@dataclasses.dataclass
class DecodeJob:
    """``steps`` greedy tokens of a batch from ``first`` (B,), the
    batched mode under Cannon; the logits of the first ``record`` steps
    come back."""
    cfg: Any
    first: np.ndarray                 # (B,) int
    s_max: int
    steps: int
    seed: int = 0
    weights: Optional[Dict] = None
    record: int = 1


@dataclasses.dataclass
class TrainJob:
    """AdamW steps of ``make_train_step`` under ``strategy`` on this PE's
    blocks, run by the training controller
    (``runtime/fault_tolerance.py::TrainController`` on the grid): step k
    on ``batches[k]``, a (tokens, labels) (B, S) pair, or with ``data`` (a
    ``DataConfig``) on the pipeline's batch of step k, steps 0 ..
    ``steps - 1``.  ``weights``: a global numpy tree, else drawn from
    ``seed``.  ``opt`` holds :class:`~repro_torch.optim.adamw.AdamWConfig`'s
    fields.  ``return_params`` sends every block back (numpy, by path)
    after the last step; ``compare_to`` names the file, ``{pe}`` in it
    standing for the PE, of the blocks (by path, ``torch.save``) each PE
    holds its own against after the last step (the largest absolute
    difference per leaf comes back).

    ``ckpt_dir``: checkpoints of the grid's stored form there every
    ``ckpt_every`` steps (after step s when ``(s + 1) % ckpt_every ==
    0``), and the job resumes from the latest one it finds.
    ``fail_at_step``: a fault drill, that step raises
    ``TransientWorkerFailure`` on every attempt, so the job stops past its
    retry budget and reports where (``stopped_at``) on every PE; the
    spawn's later jobs still run.  ``deterministic``: the PE runs the job
    under ``torch.use_deterministic_algorithms(True)``."""
    cfg: Any
    strategy: str
    batches: Optional[List] = None    # [(tokens, labels)] a step
    seed: int = 0
    weights: Optional[Dict] = None
    opt: Dict = dataclasses.field(default_factory=dict)
    remat: bool = True
    microbatches: int = 1
    grad_compress: bool = False
    return_params: bool = False
    compare_to: Optional[str] = None
    log_every: int = 0                # PE 0 prints a JSON line every N
    data: Any = None                  # a DataConfig, for steps 0..steps-1
    steps: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    fail_at_step: Optional[int] = None
    deterministic: bool = False


@dataclasses.dataclass
class ProbeJob:
    """``target(grid, *args)`` on every PE, on a heap it reserves itself
    (a probe of the grid, such as ``core/pe_grid.py::
    probe_collective_grads``); the target lives in ``repro_torch``."""
    target: Any
    args: tuple = ()


# ---------------------------------------------------------------------------
# The messages of a blocked forward or decode step.
# ---------------------------------------------------------------------------

def _esz(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def dense_messages(tag: str, strategy: str, q: int, r: int, rows: int,
                   k: int, n: int, esz: int, wsz: int,
                   kind: str = "arot") -> List[Message]:
    """The messages of one distributed GEMM of a (rows, K/q) block by a
    (K/q, N/r) weight block (:mod:`repro_torch.core.cannon`): Cannon the A
    skew (unless the A operand is skewed already, cannon_opt's ``arot``)
    and q-1 rounds of an A and a B shift; ``crot`` q-1 rounds of an
    accumulator and a B shift; allgather the A panel over the columns and
    the B panel over the rows; SUMMA per K block a column psum of A and a
    row psum of B."""
    a = rows * (k // q) * esz
    b = (k // q) * (n // r) * wsz
    c = rows * (n // r) * esz
    if strategy == "allgather":
        return [Message(f"{tag} A all_gather_cols", a, r),
                Message(f"{tag} B all_gather_rows", b, q)]
    if strategy == "summa":
        return [Message(f"{tag} A psum_cols", a, r),
                Message(f"{tag} B psum_rows", b, q)] * q
    if strategy == "cannon_opt" and kind == "crot":
        return [Message(f"{tag} C shift", c, 1),
                Message(f"{tag} B shift", b, 1)] * (q - 1)
    skew = [] if strategy == "cannon_opt" and kind == "arot" \
        else [Message(f"{tag} A skew", a, 1)]
    return skew + [Message(f"{tag} A shift", a, 1),
                   Message(f"{tag} B shift", b, 1)] * (q - 1)


def blocked_messages(cfg, plan, strategy: str, batch: int, seq: int,
                     what: str, *, hq: int, kvh: int) -> List[Message]:
    """Every message one PE puts into the heaps, in order, for ``what``:
    ``"loss"`` or ``"prefill"`` of a (batch, seq) forward under
    ``strategy``, or ``"decode"`` (one batched decode step of ``batch``
    slots, Cannon).  ``hq``/``kvh`` are a PE's heads.  Every PE puts the
    same, so ``n_pes * sum(nbytes * puts)`` is the heap traffic; the
    largest ``nbytes`` sizes the heap's slots."""
    head, layer, tail = _blocked_parts(cfg, plan, strategy, batch, seq,
                                       what, hq=hq, kvh=kvh)
    return head + layer * cfg.n_groups() + tail


def _blocked_parts(cfg, plan, strategy: str, batch: int, seq: int,
                   what: str, *, hq: int, kvh: int):
    """:func:`blocked_messages` in three parts: before the layer stack,
    one layer group, and after it."""
    q, r = plan.grid_q, plan.grid_r
    n_pes = q * r
    esz, wsz = _esz(cfg.compute_dtype), _esz(cfg.param_dtype)
    hd, D, F = cfg.hd(), cfg.d_model, cfg.d_ff
    vpad = pad_to_multiple(cfg.vocab_size, q * r)
    stats = 2 if cfg.norm == "layernorm" else 1
    decode = what == "decode"
    if decode:
        strategy = "cannon"
        b_loc, s_loc = batch // q, 1
    else:
        b_loc, s_loc = batch, seq // q
    t = b_loc * s_loc                        # this PE's token rows

    def dense(tag, rows, k, n, kind="arot"):
        return dense_messages(tag, strategy, q, r, rows, k, n, esz, wsz,
                              kind)

    def norm(tag, rows=t):
        return [Message(f"{tag} psum_cols", rows * stats * 4, r)]

    if decode:
        out = [Message("embed reduce_scatter_rows", b_loc * (D // r) * esz,
                       q)]
    else:
        out = [Message("embed reduce_scatter_rows", t * (D // r) * esz, q)]
        if cfg.vis_patches:
            out += dense("vis_proj", t, D, D, "std")
        if strategy == "cannon_opt":
            out.append(Message("skew put", t * (D // r) * esz, 1))
    group: List[Message] = []
    for mixer, ffn in cfg.pattern():
        layer = norm("norm1")
        if mixer == "attn":
            layer += dense("qkv", t, D, (hq + 2 * kvh) * r * hd)
            if not decode:
                kv = b_loc * s_loc * kvh * hd * esz
                layer += [Message("K all_gather_rows", kv, q),
                          Message("V all_gather_rows", kv, q)]
            layer += dense("wo", t, hq * r * hd, D, "crot")
        else:
            di, H = cfg.d_inner, cfg.ssm_heads
            gn, N, P = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_state, \
                cfg.ssm_headdim
            layer += dense("in_proj", t, D, 2 * di + 2 * gn + H)
            if not decode:
                layer.append(Message(
                    "conv halo put", b_loc * (cfg.conv_kernel - 1)
                    * (di + 2 * gn) // r * esz, 1))
            layer += [Message("B all_gather_cols", t * gn // r * esz, r),
                      Message("C all_gather_cols", t * gn // r * esz, r)]
            if not decode:
                layer += [Message("relay decays all_gather_rows",
                                  b_loc * H // r * 4, q),
                          Message("relay states all_gather_rows",
                                  b_loc * H // r * N * P * 4, q)]
            layer.append(Message("ssm_norm psum_cols", t * 4, r))
            layer += dense("wo", t, di, D, "crot")
        if ffn == "mlp":
            layer += norm("norm2")
            layer += dense("gate_up", t, D,
                           (2 if cfg.act == "swiglu" else 1) * F)
            layer += dense("down", t, F, D, "crot")
        elif ffn == "moe":
            cap = moe_capacity(cfg, n_pes, t)
            dl = D // r
            layer += norm("norm2")
            layer.append(Message("router psum_cols", t * cfg.n_experts * 4,
                                 r))
            for way in ("rows", "rows back"):
                if cfg.moe_wire_dtype == "int8":
                    layer += [Message(f"moe {way} all_to_all int8",
                                      cap * dl, n_pes),
                              Message(f"moe {way} all_to_all scales",
                                      cap * 4, n_pes)]
                else:
                    layer.append(Message(f"moe {way} all_to_all",
                                         cap * dl * esz, n_pes))
                if way == "rows":
                    layer.append(Message("moe expert ids all_to_all",
                                         cap * 4, n_pes))
            if not decode:
                layer.append(Message("moe balance psum_rows",
                                     2 * cfg.n_experts * 4, q))
        group += layer
    head, out = out, []
    out += norm("final")
    if decode:
        out += dense("lm_head", b_loc, D, vpad)
        out += [Message("logits all_gather_cols", b_loc * vpad // r * 4, r),
                Message("logits all_gather_rows", b_loc * vpad * 4, q)]
    elif what == "prefill":
        if strategy == "cannon_opt":
            out.append(Message("last unskew put", b_loc * (D // r) * esz, 1))
        out.append(Message("last psum_rows", b_loc * (D // r) * esz, q))
        out += dense("lm_head", b_loc, D, vpad, "std")
        out.append(Message("logits all_gather_cols", b_loc * vpad // r * 4,
                           r))
    elif what == "loss":
        nchunk = max(1, s_loc // min(1024, s_loc))
        cs = s_loc // nchunk
        for _ in range(nchunk):
            out += dense("lm_head", b_loc * cs, D, vpad)
            out += [Message("loss pmax_cols", b_loc * cs * 4, r),
                    Message("loss psum_cols", 2 * b_loc * cs * 4, r)]
        out.append(Message("loss psum_rows", 3 * 4, q))
    else:
        raise ValueError(f"what must be loss, prefill or decode: {what!r}")
    return head, group, out


def heap_bytes(messages: Sequence[Message]) -> int:
    """One PE's heap bytes of ``messages``."""
    return sum(m.nbytes * m.puts for m in messages)


# forward messages that carry no gradient: the loss's max shift (a zero
# tangent) and the integer payloads of the MoE exchange
_NO_GRAD = ("loss pmax_cols", "moe expert ids all_to_all",
            "moe rows all_to_all int8", "moe rows back all_to_all int8")


def local_tree(cfg, plan, strategy: str, pe: int = 0):
    """PE ``pe``'s blocks in ``strategy``'s storage on the meta device:
    the shapes and dtypes of its parameters, with nothing allocated."""
    return shard_params(init_params(cfg, device="meta"), cfg, plan, pe,
                        storage=storage_for(strategy))


def train_messages(cfg, plan, strategy: str, batch: int, seq: int,
                   remat: bool = True, microbatches: int = 1
                   ) -> List[Message]:
    """Every message one PE puts into the heaps in one training step
    (``make_train_step`` with a grid ``pctx``), in order by part: per
    microbatch of ``batch / microbatches`` rows, the forward
    (:func:`blocked_messages` of the loss), with ``remat`` every layer
    group's forward again (the recompute re-runs it whole), and the
    backward: the transpose of every forward message that carries a
    gradient, which puts what its forward put (a put along the inverted
    pairs, a psum of the cotangent, a reduce-scatter for a gather and
    back, the exchange back), last to first; then the reduction: the
    replicated leaves' gradients summed over the grid (one message a
    dtype, fp32 with microbatches), the kv column replicas' over their
    groups, and the squared norm's sum."""
    from repro_torch.train.step import kv_replicas, reduction_parts
    q, r = plan.grid_q, plan.grid_r
    n_pes = q * r
    local = local_tree(cfg, plan, strategy)
    hq, kvh = _pe_heads(local, cfg)
    head, layer, tail = _blocked_parts(cfg, plan, strategy,
                                       batch // microbatches, seq, "loss",
                                       hq=hq, kvh=kvh)
    G = cfg.n_groups()
    fwd = head + layer * G + tail
    back = [Message(f"{m.what} (transpose)", m.nbytes, m.puts)
            for m in reversed(fwd) if m.what not in _NO_GRAD]
    out = (fwd + (layer * G if remat else []) + back) * microbatches
    from repro_torch.tree import flatten_with_paths
    parts = [[t[g] for g in range(t.shape[0])] if p.startswith("['layers']")
             else [t] for p, t in zip(*flatten_with_paths(local))]
    rep = kv_replicas(cfg, r)
    repl, tied = reduction_parts(local, parts, rep)
    for idx, what, puts in ((repl, "grads psum_all", n_pes),
                            (tied, "kv replicas psum_groups", rep)):
        by_dtype: Dict[Any, int] = {}
        for li, k in idx:
            t = parts[li][k]
            dt = torch.float32 if microbatches > 1 else t.dtype
            by_dtype[dt] = by_dtype.get(dt, 0) + t.numel() * _esz(dt)
        out += [Message(f"{what} {dt}", n, puts)
                for dt, n in by_dtype.items()]
    out.append(Message("grad norm psum_all", 4, n_pes))
    return out


def _pe_heads(params, cfg):
    """(q heads, kv heads) of this PE's blocks; (0, 0) with no
    attention."""
    hd = cfg.hd()
    for layer in params["layers"]:
        m = layer["mixer"]
        if "wq" in m:
            return m["wq"].shape[-1] // hd, m["wk"].shape[-1] // hd
    return 0, 0


# ---------------------------------------------------------------------------
# The PE target.
# ---------------------------------------------------------------------------

def _counts(delta) -> Dict[str, Any]:
    """Launches and launches by variant of every wrapper that moved."""
    return {fn.__name__: {"launches": n, "by_variant": var}
            for fn, (n, var) in delta.items()}


def _sync(grid) -> None:
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)


def _measured(grid, fn):
    """``fn()`` between two barriers: its result, wall, the grid's counter
    deltas and the kernels' launches."""
    grid.barrier_all()
    before, c0 = launch_counts(), grid.counters()
    t0 = time.perf_counter()
    out = fn()
    _sync(grid)
    wall = time.perf_counter() - t0
    c1 = grid.counters()
    rec = {k: c1[k] - c0[k] for k in ("collectives", "puts", "heap_bytes",
                                      "wait_s")}
    rec.update(wall_s=wall, launches=_counts(count_delta(before,
                                                         launch_counts())))
    return out, rec


class _Drawn:
    """The global tree of the last model this PE drew from a seed, kept
    while consecutive jobs run that model (each cuts its own storage
    from it): one draw a model, not one a job.  Every PE holds its own
    copy (the smoke's models hold at most 3.1 GB each)."""

    def __init__(self):
        self.key, self.tree = None, None

    def params(self, grid, job, storage, keep: bool = True):
        if job.weights is not None:
            return pe_params(grid, job.cfg, weights=job.weights,
                             storage=storage)
        if not keep:
            # the PEs draw in turn and keep no tree (a model whose full
            # tree four times over would crowd the card)
            self.key = self.tree = None
            return pe_params(grid, job.cfg, seed=job.seed, storage=storage)
        key = (job.cfg, job.seed)
        if self.key != key:
            self.key = self.tree = None
            if grid.device.type == "cuda":
                torch.cuda.empty_cache()
            gen = torch.Generator(device=grid.device).manual_seed(job.seed)
            self.tree = init_params(job.cfg, generator=gen,
                                    device=grid.device)
            self.key = key
        return shard_params(self.tree, job.cfg, _plan(grid), grid.pe,
                            storage=storage)


def _reserve(grid, cfg, messages) -> None:
    moe = any(f == "moe" for _, f in cfg.pattern())
    grid.reserve(max(m.nbytes for m in messages), all_to_all=moe)


def _forward(grid, job: ForwardJob, drawn: _Drawn) -> Dict[str, Any]:
    cfg, plan = job.cfg, _plan(grid)
    t0 = time.perf_counter()
    params = drawn.params(grid, job, storage_for(job.strategy))
    hq, kvh = _pe_heads(params, cfg)
    B, S = job.tokens.shape
    msgs = {w: blocked_messages(cfg, plan, job.strategy, B, S, w, hq=hq,
                                kvh=kvh) for w in ("loss", "prefill")}
    _reserve(grid, cfg, msgs["loss"] + msgs["prefill"])
    setup_s = time.perf_counter() - t0
    pctx = make_pctx(grid, job.strategy, cfg.compute_dtype)
    dev = grid.device
    batch = {"tokens": torch.from_numpy(np.asarray(job.tokens, np.int32))
             .to(dev),
             "labels": torch.from_numpy(np.asarray(job.labels, np.int32))
             .to(dev)}
    loss_fn = make_loss_fn(cfg, pctx=pctx)
    prefill = make_prefill(cfg, pctx=pctx)
    out: Dict[str, Any] = {"loss_runs": [], "prefill_runs": []}
    for _ in range(job.runs):
        (loss, metrics), rec = _measured(grid, lambda: loss_fn(params, batch))
        out["loss_runs"].append(rec)
        logits, rec = _measured(grid, lambda: prefill(params, batch))
        out["prefill_runs"].append(rec)
    out.update(
        loss=float(loss), ce_loss=float(metrics["ce_loss"]),
        aux=float(metrics["aux"]), n_tokens=int(metrics["n_tokens"]),
        logits=logits.float().cpu().numpy(),
        reckoned_heap_bytes={w: heap_bytes(m) for w, m in msgs.items()},
        reckoned_collectives={w: len(m) for w, m in msgs.items()},
        heads=(hq, kvh), setup_s=setup_s)
    return out


def _decode(grid, job: DecodeJob, drawn: _Drawn) -> Dict[str, Any]:
    cfg, plan = job.cfg, _plan(grid)
    t0 = time.perf_counter()
    params = drawn.params(grid, job, True)
    hq, kvh = _pe_heads(params, cfg)
    B = len(job.first)
    msgs = blocked_messages(cfg, plan, "cannon", B, 1, "decode", hq=hq,
                            kvh=kvh)
    _reserve(grid, cfg, msgs)
    setup_s = time.perf_counter() - t0
    pctx = make_pctx(grid, "cannon", cfg.compute_dtype)
    dev = grid.device
    cache = cache_specs(cfg, B, job.s_max, "batched",
                        kvh=kvh * grid.r if hq else None, device=dev,
                        pctx=pctx)
    step = make_decode_step(cfg, batch=B, s_max=job.s_max, pctx=pctx)
    tok = torch.from_numpy(np.asarray(job.first, np.int32)).to(dev)
    tokens, rows, steps = [tok.cpu().numpy()], [], []
    for t in range(job.steps):
        logits, rec = _measured(grid, lambda: step(params, cache, tok, t))
        steps.append(rec)
        if t < job.record:
            rows.append(logits[:, 0].float().cpu().numpy())
        tok = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1).to(
            torch.int32)
        tokens.append(tok.cpu().numpy())
    return {"tokens": np.stack(tokens, 1), "rows": rows, "steps": steps,
            "reckoned_heap_bytes": heap_bytes(msgs),
            "reckoned_collectives": len(msgs), "heads": (hq, kvh),
            "setup_s": setup_s}


def heap_launches(messages: Sequence[Message]) -> Dict[str, int]:
    """The heap kernels' launches on one PE for ``messages`` of float
    payloads (:func:`train_messages`, :func:`blocked_messages`): one
    ``shmem_put`` a put, one ``shmem_reduce_slots`` a sum or max, a
    reduce-scatter, or a gather's transpose (a reduce-scatter)."""
    red = 0
    for m in messages:
        back = m.what.endswith("(transpose)")
        if "psum" in m.what or "pmax" in m.what:
            red += 1
        elif "reduce_scatter" in m.what:
            red += not back
        elif "all_gather" in m.what:
            red += back
    return {"shmem_put": sum(m.puts for m in messages),
            "shmem_reduce_slots": red}


def _job_batch(job: TrainJob, step: int):
    """Step ``step``'s (tokens, labels) of ``job``."""
    if job.batches is not None:
        return job.batches[step]
    from repro_torch.data.pipeline import make_batch as pipeline_batch
    b = pipeline_batch(job.data, step, 0, 1)
    return b["tokens"], b["labels"]


def _train(grid, job: TrainJob, drawn: _Drawn) -> Dict[str, Any]:
    prev = torch.are_deterministic_algorithms_enabled()
    if job.deterministic:
        # cuBLAS needs a fixed workspace for reproducible products
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        return _train_steps(grid, job, drawn)
    finally:
        torch.use_deterministic_algorithms(prev)


def _train_steps(grid, job: TrainJob, drawn: _Drawn) -> Dict[str, Any]:
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.runtime.fault_tolerance import (
        FaultConfig, TrainController, TransientWorkerFailure)
    from repro_torch.train.step import init_resid, make_train_step
    from repro_torch.tree import flatten_with_paths
    cfg, plan = job.cfg, _plan(grid)
    storage = storage_for(job.strategy)
    n_steps = len(job.batches) if job.batches is not None else job.steps
    t0 = time.perf_counter()
    params = drawn.params(grid, job, storage,
                          keep=not any(f == "moe" for _, f in cfg.pattern()))
    B, S = np.asarray(_job_batch(job, 0)[0]).shape
    msgs = train_messages(cfg, plan, job.strategy, B, S, job.remat,
                          job.microbatches)
    # psum_all sums over every PE: n_pes slots a half
    grid.reserve(max(m.nbytes for m in msgs), all_to_all=True)
    pctx = make_pctx(grid, job.strategy, cfg.compute_dtype)
    opt_cfg = AdamWConfig(**job.opt)
    opt_state = init_state(params, opt_cfg)
    if job.grad_compress:
        opt_state["resid"] = init_resid(params, torch.float32)
    step = make_train_step(cfg, opt_cfg=opt_cfg, remat=job.remat,
                           microbatches=job.microbatches,
                           grad_compress=job.grad_compress, pctx=pctx)
    dev = grid.device
    steps = []

    def batch_of(k):
        toks, labels = _job_batch(job, k)
        return {"tokens": torch.from_numpy(np.asarray(toks, np.int32))
                .to(dev),
                "labels": torch.from_numpy(np.asarray(labels, np.int32))
                .to(dev)}

    def measured_step(p, o, batch):
        k = ctrl.step                     # this step's index
        (p, o, m), rec = _measured(grid, lambda: step(p, o, batch))
        rec.update({k_: float(m[k_]) for k_ in ("loss", "ce_loss", "aux",
                                                 "grad_norm", "lr")})
        rec["step"] = k
        steps.append(rec)
        if grid.pe == 0 and job.log_every and (
                k % job.log_every == 0 or k == n_steps - 1):
            print(json.dumps({"step": k, "loss": rec["loss"],
                              "ce_loss": rec["ce_loss"],
                              "grad_norm": rec["grad_norm"], "lr": rec["lr"],
                              "seconds": rec["wall_s"],
                              "collectives": rec["collectives"]}),
                  flush=True)
        return p, o, m

    def injector(k):
        if k == job.fail_at_step:
            raise TransientWorkerFailure(f"fault drill at step {k}")

    fcfg = FaultConfig(ckpt_dir=job.ckpt_dir, ckpt_every=job.ckpt_every,
                       fail_injector=injector
                       if job.fail_at_step is not None else None)
    ctrl = TrainController(measured_step, batch_of, fcfg, cfg=cfg,
                           device=dev, grid=grid, storage=storage)
    start, params, opt_state = ctrl.resume_or_init(params, opt_state)
    setup_s = time.perf_counter() - t0
    stopped_at = None
    try:
        params, opt_state = ctrl.run(params, opt_state, n_steps, start)
    except TransientWorkerFailure:
        stopped_at = ctrl.step
    out: Dict[str, Any] = {
        "steps": steps, "reckoned_heap_bytes": heap_bytes(msgs),
        "reckoned_collectives": len(msgs),
        "reckoned_heap_launches": heap_launches(msgs), "setup_s": setup_s,
        "max_message_bytes": max(m.nbytes for m in msgs),
        "start_step": start, "stopped_at": stopped_at,
        "retries": ctrl.retries, "skipped": ctrl.skipped,
        "checkpoints": ctrl.saves, "restored": ctrl.restored,
        "ckpt_step": None if not job.ckpt_dir
        else ckpt_latest(job.ckpt_dir)}
    paths, flat = flatten_with_paths(params)
    if job.return_params:
        out["params"] = {p: t.float().cpu().numpy()
                         for p, t in zip(paths, flat)}
    if job.compare_to is not None:
        want = torch.load(job.compare_to.format(pe=grid.pe),
                          map_location=dev)
        out["param_max_abs_err"] = {
            p: float((want[p].float() - t.float()).abs().max())
            for p, t in zip(paths, flat)}
        del want
    del params, opt_state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _plan(grid):
    from repro_torch.partition import grid_plan
    return grid_plan(grid.q, grid.r)


def grid_run_pe(grid, jobs: Sequence) -> List[Dict[str, Any]]:
    """The PE target of :func:`run_on_grid`: each job on this PE, its
    heap reserved before and freed after."""
    t_enter = time.time()
    out, drawn = [], _Drawn()
    for job in jobs:
        t0 = time.perf_counter()
        if isinstance(job, ForwardJob):
            res = _forward(grid, job, drawn)
        elif isinstance(job, DecodeJob):
            res = _decode(grid, job, drawn)
        elif isinstance(job, TrainJob):
            res = _train(grid, job, drawn)
        elif isinstance(job, ProbeJob):
            res = {"result": job.target(grid, *job.args)}
        elif isinstance(job, GridJob):
            # served as serve_on_grid serves it, heap and report its own
            res = grid_serve_pe(grid, [job])[0]
            res["job_s"] = time.perf_counter() - t0
            out.append(res)
            continue
        else:
            raise TypeError(f"not a grid job: {job!r}")
        res.update(pe=grid.pe, device=str(grid.device),
                   heap=type(grid.heap).__name__,
                   heap_slot_bytes=grid.slot_bytes,
                   heap_mb=0.0 if grid.heap is None
                   else grid.heap.nbytes / 1e6)
        grid.close()
        res["job_s"] = time.perf_counter() - t0
        out.append(res)
    for res in out:       # the spawn's own cost, read against the caller's
        res.update(t_enter=t_enter, t_leave=time.time())
    return out


def run_on_grid(jobs: Sequence, plan, *, device: str = "cuda",
                timeout: float = 300.0) -> List[List[Dict[str, Any]]]:
    """Run every job in one spawn of ``plan``'s grid; returns, per job,
    every PE's report in PE order."""
    from repro_torch.launch import grid_run   # the target by its module
    from repro_torch.runtime.pe import run_pes
    per_pe = run_pes(grid_run.grid_run_pe, plan, args=(list(jobs),),
                     device=device, timeout=timeout)
    return [[per_pe[pe][k] for pe in range(plan.n_pes)]
            for k in range(len(jobs))]


def probe_mamba_blocks(grid, cases: Sequence) -> List[np.ndarray]:
    """:func:`probe_mamba_block` for each (cfg, weights, x, strategy) of
    ``cases``, each on a heap of its own: a PE target."""
    out = []
    for case in cases:
        out.append(probe_mamba_block(grid, *case))
        grid.close()
    return out


def probe_mamba_block(grid, cfg, weights, x: np.ndarray,
                      strategy: str) -> np.ndarray:
    """The first mamba layer of ``cfg`` (global numpy ``weights``) on this
    PE's block of the residual x (B, S, D), sequence-sharded
    (``models/ssm.py::mamba_block`` with a blocked ``pctx``): returns this
    PE's output block, in the residual layout of ``strategy`` (skewed
    under cannon_opt).  The grid's check against the block on the whole
    sequence."""
    from repro_torch.core.cannon import skew_activation
    from repro_torch.models.ssm import mamba_block
    from repro_torch.models.transformer import layer_params
    params = pe_params(grid, cfg, weights=weights,
                       storage=storage_for(strategy))
    pctx = make_pctx(grid, strategy, cfg.compute_dtype)
    pos = [m for m, _ in cfg.pattern()].index("mamba")
    p = layer_params(params["layers"][pos], 0)["mixer"]
    i, j = grid.my_coords()
    B, S, D = x.shape
    s_loc, d_loc = S // grid.q, D // grid.r
    blk = torch.from_numpy(np.ascontiguousarray(
        x[:, i * s_loc:(i + 1) * s_loc, j * d_loc:(j + 1) * d_loc])).to(
            grid.device, cfg.compute_dtype)
    msgs = blocked_messages(cfg, _plan(grid), strategy, B, S, "loss",
                            hq=0, kvh=0)
    _reserve(grid, cfg, msgs)
    if strategy == "cannon_opt":
        blk = skew_activation(grid, blk)
    with torch.no_grad():
        y = mamba_block(p, blk, cfg, pctx)
    grid.barrier_all()
    return y.float().cpu().numpy()


def make_batch(cfg, batch: int, seq: int, seed: int = 0):
    """Tokens (B, S) drawn from ``seed`` and their next-token labels,
    the last position masked (-100)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(
        np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -100
    return toks[:, :-1], labels


def main(argv=None):
    # the jobs' classes by their module: a spawned PE unpickles them there
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.grid_run import (DecodeJob, ForwardJob,
                                             make_batch, run_on_grid)
    from repro_torch.partition import parse_grid
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--strategies", nargs="+", default=list(TP_STRATEGIES))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--decode-batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    plan = parse_grid(args.grid)
    device = args.device or "cuda"
    toks, labels = make_batch(cfg, args.batch, args.seq_len)
    jobs: List[Any] = [ForwardJob(cfg, s, toks, labels)
                       for s in args.strategies]
    first = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(args.decode_batch,))
    jobs.append(DecodeJob(cfg, first, s_max=max(args.tokens, 8),
                          steps=args.tokens))
    runs = run_on_grid(jobs, plan, device=device)
    for job, reports in zip(jobs, runs):
        pe0 = reports[0]
        if isinstance(job, ForwardJob):
            rec = pe0["loss_runs"][-1]
            print(f"{job.strategy:10s} loss {pe0['loss']:.6f}  "
                  f"{rec['wall_s'] * 1e3:.1f} ms, {rec['collectives']} "
                  f"collectives, {rec['heap_bytes']} heap bytes a PE "
                  f"({pe0['reckoned_heap_bytes']['loss']} reckoned)")
        else:
            walls = [s["wall_s"] for s in pe0["steps"]]
            print(f"batched decode: {pe0['tokens'][0].tolist()} ... "
                  f"{1e3 * float(np.mean(walls)):.1f} ms a step")


if __name__ == "__main__":
    main()
