"""The training step on one device (``repro.train.step`` at q = r = 1).

``make_train_step`` returns ``step_fn(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradient by autograd
(microbatches accumulated in fp32), the gradient reduction, and AdamW,
with the metrics of the JAX step (loss, ce_loss, aux, n_tokens,
grad_norm, lr).

On one device the JAX reduction rules collapse: every psum over the data
and model axes is the identity, a leaf's global norm counts each element
once, and the kv heads have no column replicas to tie.  What stays is the
compressed path (``grad_compress``): the model-sharded leaves (the layouts
the JAX package stores in blocks: ``blocked2d``, ``vocab2d``,
``expert_flat``) take the int8 round trip with the error-feedback residual
``opt_state["resid"]``, the replicated ones (norms, biases, router, conv,
A, dt_bias, D) pass as they are.  The global norm is taken after it.

The step has no ``tp_strategy`` argument: on one card cannon, cannon_opt,
allgather and summa compute the same product, so the step has one form
(as ``EngineConfig`` has no ``kernel_backend``).  On a grid of PE
processes :func:`make_train_step` and the forward-only
:func:`make_loss_fn` take a ``pctx`` from :func:`make_pctx`, which names
the strategy: the step then runs on one PE's blocks, its backward through
the grid's puts and collectives, and the reduction takes the JAX rules
(replicated leaves summed over the grid, kv column replicas over their
replica groups, the norm's blocked squares over the grid).

The step differentiates the parameters through per-group views: each leaf
stacked over the G layer groups is handed to the forward as a
:class:`~repro_torch.tree.Pieces` of its G slices, each a leaf of the
autograd graph, so each layer's gradient is its own tensor and no
full-leaf gradient is assembled; AdamW then updates the leaf slice by
slice, in place (:mod:`repro_torch.optim.adamw`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TP_STRATEGIES, ParallelContext
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     lr_schedule, pieces_of, slices)
from repro_torch.optim.compress import compressed_allreduce
from repro_torch.tree import Pieces, flatten_with_paths, leaves, unflatten

# leaf name -> the layout the JAX package stores it in (``param_specs``);
# any other name is replicated
LAYOUTS = {**dict.fromkeys(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                            "w_down", "wz", "wx", "wb", "wc", "wdt",
                            "lm_head", "vis_proj"), "blocked2d"),
           "embed": "vocab2d", "w1": "expert_flat", "w2": "expert_flat"}
# replicated leaves drawn from a normal init, which the JAX decay mask
# decays with the matrices
DECAYED_REPLICATED = ("router", "conv_w")


def leaf_name(path: str) -> str:
    """The last key of a flattened path: ``['layers']/[0]/['mixer']/['wq']``
    -> ``wq``."""
    return path.rsplit("/", 1)[-1].strip("[]'")


def leaf_layout(path: str) -> str:
    return LAYOUTS.get(leaf_name(path), "replicated")


def decay_mask(params) -> Any:
    """Weight decay on the matrices only: every model-sharded leaf, and
    the router and the conv weights (``repro.train.step.decay_mask``)."""
    paths, _ = flatten_with_paths(params)
    return unflatten(params, [leaf_layout(p) != "replicated"
                              or leaf_name(p) in DECAYED_REPLICATED
                              for p in paths])


def init_resid(params, dtype=torch.bfloat16) -> Any:
    """The compressed path's zero residuals, one per leaf (bf16, as the
    JAX launcher makes them)."""
    return unflatten(params, [torch.zeros(p.shape, dtype=dtype,
                                          device=p.device)
                              for p in leaves(params)])


def _views(params) -> Tuple[Any, List[List[torch.Tensor]]]:
    """The tree the forward differentiates: every leaf a detached alias
    that requires grad, a stacked layer leaf a Pieces of its group slices.
    Also each leaf's list of autograd leaves."""
    groups: List[List[torch.Tensor]] = []
    paths, flat = flatten_with_paths(params)
    out = []
    for path, p in zip(paths, flat):
        if path.startswith(("['layers']", "['enc_layers']")):
            vs = [p[g].detach().requires_grad_(True)
                  for g in range(p.shape[0])]
            out.append(Pieces(vs))
        else:
            vs = [p.detach().requires_grad_(True)]
            out.append(vs[0])
        groups.append(vs)
    return unflatten(params, out), groups


def _grads(cfg, params, batch, remat, pctx=None):
    """(loss, metrics, per-leaf gradient lists) of one batch."""
    view_tree, groups = _views(params)
    loss, metrics = loss_fn(cfg, view_tree, batch, remat, pctx=pctx)
    flat = [v for vs in groups for v in vs]
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    out, i = [], 0
    for vs in groups:
        out.append([torch.zeros_like(v) if g is None else g
                    for v, g in zip(vs, gs[i:i + len(vs)])])
        i += len(vs)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out


def _replica_groups(q: int, r: int, rep: int, skewed: bool
                    ) -> List[List[int]]:
    """PE groups whose blocks hold the same logical (K_a, kv head g) tile
    (``repro/train/step.py:55-70``): unskewed, block (i, j) holds
    W[K_i, N_{j // rep}], so the cols of a row tie; pre-skewed, block
    (i, j) holds W[K_{(i+j) % q}, N_{j // rep}], so the col-j replica of
    K_a sits at row (a - j) % q and a group spans rows."""
    groups = []
    for a in range(q):
        for g in range(r // rep):
            cols = [g * rep + t for t in range(rep)]
            groups.append([((a - j) % q) * r + j if skewed else a * r + j
                           for j in cols])
    return groups


def _summed(fn, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """``fn`` (a psum of the grid) over every tensor of ``grads`` in one
    collective a dtype: each dtype's tensors flattened into one message,
    summed, and cut back (a psum is elementwise: the bits of a psum a
    leaf)."""
    out = list(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for k, t in enumerate(grads):
        by_dtype.setdefault(t.dtype, []).append(k)
    for ks in by_dtype.values():
        flat = fn(torch.cat([grads[k].reshape(-1) for k in ks]))
        parts = flat.split([grads[k].numel() for k in ks])
        for k, part in zip(ks, parts):
            out[k] = part.view(grads[k].shape)
    return out


def kv_replicas(cfg: ModelConfig, r: int) -> int:
    """Columns a stored kv head is repeated over on a grid of ``r``
    columns (the ``col_replicas`` of ``wk``/``wv``): ``r / n_kv_heads``
    where the kv heads are fewer than the columns, else 1."""
    if r == 1 or not cfg.n_kv_heads \
            or all(m != "attn" for m, _ in cfg.pattern()):
        return 1
    return cfg.kv_stored(r)[1]


def reduction_parts(params, grads: List[List[torch.Tensor]], rep: int):
    """(replicated, tied) gradient parts of the grid's reduction, as
    (leaf, part) indices in leaf order: every part of a replicated leaf,
    and with ``rep`` > 1 every part of ``wk`` and ``wv``."""
    paths = flatten_with_paths(params)[0]
    repl = [(li, k) for li, path in enumerate(paths)
            if leaf_layout(path) == "replicated"
            for k in range(len(grads[li]))]
    tied = [(li, k) for li, path in enumerate(paths)
            if rep > 1 and leaf_name(path) in ("wk", "wv")
            for k in range(len(grads[li]))]
    return repl, tied


def _grid_reduce(params, grads: List[List[torch.Tensor]], pctx, rep: int
                 ) -> List[List[torch.Tensor]]:
    """The JAX reduction's collectives on one PE's gradient parts: every
    replicated leaf summed over the grid, the kv column replicas (``rep``
    > 1) summed over their :func:`_replica_groups` (spanning rows under
    the pre-skewed storage); the blocked leaves' data-axis sums are the
    identity (the grid has no data axis)."""
    grid = pctx.grid
    repl, tied = reduction_parts(params, grads, rep)
    groups = _replica_groups(grid.q, grid.r, rep, pctx.preskewed)
    out = [list(g) for g in grads]
    for idx, fn in ((repl, grid.psum_all),
                    (tied, lambda t: grid.psum_groups(t, groups))):
        if not idx:
            continue
        summed = _summed(fn, [out[li][k] for li, k in idx])
        for (li, k), t in zip(idx, summed):
            out[li][k] = t
    return out


def reduce_grads(params, grads: List[List[torch.Tensor]], resid=None,
                 pctx=None, rep: int = 1):
    """The JAX reduction over per-leaf gradient lists.  At 1x1: the
    compressed path for model-sharded leaves when ``resid`` is given
    (updating it in place), then the global norm (blocked and replicated
    leaves summed apart, as the JAX step does).  With a grid ``pctx`` the
    grid's sums first (:func:`_grid_reduce`; ``rep`` from
    :func:`kv_replicas`), the compressed path on each local block as at
    1x1 (a data axis of one worker), and the norm over the grid: the
    blocked leaves' squares summed over every PE (a kv column replica's
    divided by its ``rep`` copies), the replicated leaves' counted once.
    Returns (grads as a tree of tensors / Pieces, grad norm)."""
    grid = None if pctx is None or pctx.local else pctx.grid
    if grid is not None:
        grads = _grid_reduce(params, grads, pctx, rep)
    paths, flat_p = flatten_with_paths(params)
    flat_r = leaves(resid) if resid is not None else [None] * len(flat_p)
    out = []
    sq_b = sq_r = torch.zeros((), dtype=torch.float32,
                              device=flat_p[0].device)
    for path, p, g, rd in zip(paths, flat_p, grads, flat_r):
        g = Pieces(g) if len(g) > 1 else g[0]
        layout = leaf_layout(path)
        if rd is not None and layout != "replicated":
            rf = rd.view(-1)
            parts = []
            for lo, hi, gs in slices(g):
                summed, new_r = compressed_allreduce(gs, rf[lo:hi])
                rf[lo:hi] = new_r.to(rd.dtype)
                parts.append(summed)
            g = torch.cat(parts).reshape(p.shape) if len(parts) > 1 \
                else parts[0].reshape(p.shape)
        contrib = sum(torch.sum(torch.square(t.float()))
                      for t in pieces_of(g))
        if layout == "replicated":
            sq_r = sq_r + contrib
        elif rep > 1 and leaf_name(path) in ("wk", "wv"):
            sq_b = sq_b + contrib / rep
        else:
            sq_b = sq_b + contrib
        out.append(g)
    if grid is not None:
        sq_b = grid.psum_all(sq_b)
    return unflatten(params, out), torch.sqrt(sq_b + sq_r)


def _split(batch: Dict[str, torch.Tensor], n: int, i: int):
    b = next(iter(batch.values())).shape[0] // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True, microbatches: int = 1,
                    grad_compress: bool = False,
                    pctx: Optional[ParallelContext] = None) -> Callable:
    """Returns ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` and ``opt_state`` (``init_state``, plus
    ``resid`` from :func:`init_resid` with ``grad_compress``) are updated
    in place and returned, and left untouched when the loss is not finite
    (one read of the loss on the host a step, none on the meta device);
    ``batch`` holds tokens and labels (B, S) on the parameters' device.  With ``microbatches`` the batch splits along B,
    each part's gradient is accumulated in fp32 and the mean taken, as the
    JAX step does; its ce_loss is then the mean loss, aux and n_tokens 0.

    With a grid ``pctx`` (:func:`make_pctx`, which names the strategy)
    the step runs on one PE's blocks (``shard_params(..., storage=
    storage_for(strategy))``), as the body of the JAX step's
    ``shard_map``: the blocked forward, its backward through every put and
    collective (their transposes, :mod:`repro_torch.core.pe_grid`), the
    grid's reduction (:func:`reduce_grads`) and AdamW on the local blocks
    (8-bit moments quantised per local block).  Every PE gets the same
    loss bits (the row sums reduce in slot order), so every PE decides
    the non-finite guard alike.  As in the JAX step, whose ``psum``
    transposes to a ``psum`` under ``check_vma=False``, every PE seeds
    the replicated loss, so the gradients and ``grad_norm`` come out q*r
    times the model's, and the clip acts at a true norm of ``grad_clip /
    (q*r)``."""
    if pctx is not None and not pctx.local and not pctx.blocked:
        raise ValueError("the step on a grid runs in the blocked layout "
                         "(make_pctx)")
    rep = kv_replicas(cfg, 1 if pctx is None else pctx.r)

    def step_fn(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _grads(cfg, params, batch, remat, pctx)
        else:
            loss, grads = 0.0, None
            for i in range(microbatches):
                l_i, _, g_i = _grads(cfg, params,
                                     _split(batch, microbatches, i), remat,
                                     pctx)
                loss = loss + l_i
                g_i = [[t.float() for t in gl] for gl in g_i]
                grads = g_i if grads is None else [
                    [a + b for a, b in zip(ga, gb)]
                    for ga, gb in zip(grads, g_i)]
            grads = [[t / microbatches for t in gl] for gl in grads]
            loss = loss / microbatches
            dev = loss.device
            metrics = {"ce_loss": loss,
                       "aux": torch.zeros((), device=dev),
                       "n_tokens": torch.zeros((), dtype=torch.int32,
                                               device=dev)}
        # on the meta device (the dry run) there is no loss to read: the
        # update runs
        if not loss.is_meta and not bool(torch.isfinite(loss)):
            # in place, the update would poison the state: leave it as it
            # is (the JAX controller drops the returned state instead)
            nan = torch.full((), float("nan"), device=loss.device)
            return params, opt_state, dict(
                metrics, loss=loss, grad_norm=nan,
                lr=lr_schedule(opt_cfg, opt_state["step"] + 1))
        resid = opt_state.get("resid") if grad_compress else None
        tree, gnorm = reduce_grads(params, grads, resid, pctx, rep)
        del grads
        adam = {k: opt_state[k] for k in ("step", "m", "v")}
        params, adam, om = apply_updates(params, tree, adam, opt_cfg,
                                         decay_mask=decay_mask(params),
                                         grad_norm=gnorm)
        opt_state = dict(opt_state, **adam)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step_fn


def make_pctx(grid, tp_strategy: str = "cannon",
              compute_dtype: torch.dtype = torch.float32) -> ParallelContext:
    """The blocked forward's context on one PE's ``grid``
    (``repro.train.step.make_pctx``): weights pre-skewed for cannon and
    cannon_opt (which also keeps the residual stream skewed), natural for
    the allgather and SUMMA baselines.  Shard the weights with
    ``shard_params(..., storage=storage_for(tp_strategy))``."""
    if tp_strategy not in TP_STRATEGIES:
        raise ValueError(f"tp_strategy must be one of {TP_STRATEGIES}, got "
                         f"{tp_strategy!r}")
    return ParallelContext(
        grid=grid, tp_strategy=tp_strategy,
        preskewed=tp_strategy in ("cannon", "cannon_opt"),
        act_layout="skewed" if tp_strategy == "cannon_opt" else "blocked",
        compute_dtype=compute_dtype)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = False,
                 pctx: Optional[ParallelContext] = None) -> Callable:
    """Forward only: ``fn(params, batch) -> (loss, metrics)`` under
    ``torch.no_grad()``.  With a grid ``pctx`` (:func:`make_pctx`) the
    blocked forward on this PE's blocks; every PE returns the global
    loss."""
    if pctx is not None and not pctx.local and not pctx.blocked:
        raise ValueError("the loss on a grid runs in the blocked layout "
                         "(make_pctx)")

    def fn(params, batch):
        with torch.no_grad():
            return loss_fn(cfg, params, batch, remat, pctx=pctx)
    return fn
