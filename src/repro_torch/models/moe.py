"""Mixture-of-Experts block on one device: ``repro.models.moe.moe_block``
on a 1x1 grid.

On one card every expert is local and the dispatch and combine exchanges
(``all_to_all`` over the flat PE space) are the identity; what is left is
the router, the capacity rule, the grouped expert FFN and the weighted
combine, each rounded where the JAX block rounds:

  * router logits ``x.float() @ router`` in fp32 (the router is an fp32
    leaf even in bf16 models), softmax, ``topk``, the ``router_renorm``
    division with its 1e-9 floor;
  * capacity ``cap = ceil(T * k / n_pes * capacity_factor)`` at n_pes = 1.
    With one PE a pair's rank among the pairs bound for its PE is its index
    in flat ``(token, k)`` order, so the pairs at index ``>= cap`` drop:
    none at ``capacity_factor >= 1``;
  * the pairs sorted by expert (stable), dropped pairs last under the
    sentinel id E; offsets from a fixed-size count and a cumsum;
  * ``grouped_mm_swiglu`` with ``w1`` (gate | up along the last axis): the
    product, ``silu`` of the gate in fp32 rounded to x's dtype, times the up
    half in x's dtype, one launch on the card that never writes the
    (M, 2F) product; ``grouped_mm`` with ``w2``; unsorted;
  * the fp32 combine, one fixed-shape sum over k (the JAX block's
    ``.at[ft].add`` adds each token's k contributions), then cast to x's
    dtype;
  * with ``moe_wire_dtype == "int8"`` the rows are quantised and
    dequantised where the JAX block sends them (per row, scale
    ``max|x| / 127 + 1e-12``): on one card the exchange is the identity,
    the rounding is not.

Every shape is fixed by (T, k): M = T * k rows always, dropped pairs parked
past ``offsets[E]`` where the grouped GEMM writes zeros.  Nothing reads a
count on the host (no ``bincount``, ``nonzero``, boolean indexing or
``.item()``), so a step body holding the block can be captured as a CUDA
graph, and the combine uses no atomics, so a replay gives the same bits.

On one PE of a ``q x r`` grid of PE processes (``moe_ffn`` or
``moe_block`` with a grid ``pctx``) the block takes the form of
``repro/models/moe.py:32-157`` (:func:`_moe_grid`): experts over the flat
PE space (PE p owns experts ``[p E_loc, (p+1) E_loc)``), tokens with their
features over the columns (row-replicated in the engine's ``repl_rows``
layout; in the blocked layouts each row's B S_loc tokens differ, and under
``skewed`` PE (i, j) holds feature block ``(i + j) % q``, which the router
slice and the full-D reassembly follow), dispatch and combine as
``all_to_all`` exchanges through the symmetric heap, and capacity per
owner PE.  Its shapes are fixed by (T, k) too: every exchange carries
``cap`` rows a PE pair.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.grouped_mm import grouped_mm, grouped_mm_swiglu
from repro_torch.models.layers import ParallelContext


def _quantise(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and fp32 scales ``max|x| / 127 + 1e-12``
    (``moe.py:88-94``)."""
    f = t.float()
    sc = f.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(f / sc), -127, 127).to(torch.int8), sc


def _int8_wire(t: torch.Tensor) -> torch.Tensor:
    """The int8 dispatch/combine round trip of ``moe.py:88-94``, per row."""
    q8, sc = _quantise(t)
    return (q8.float() * sc).to(t.dtype)


def _moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg):
    """x (B, S, D) -> (y same shape and dtype, router logits (T, E) fp32,
    probs (T, E), top_e (T, k)).  ``p``: router (D, E) fp32, w1 (E, D, 2F),
    w2 (E, F, D) in the global layout."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    n = T * k
    dev = x.device

    x2 = x.reshape(T, D)
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)            # (T, k)
    if cfg.router_renorm:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- dispatch: sort the (token, k) pairs by expert ----------------------
    fe = top_e.reshape(n)
    fw = top_w.reshape(n).float()
    ft = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(n)
    valid = torch.arange(n, device=dev) < _n_kept(n, cfg)
    key = torch.where(valid, fe, E)                        # E: dropped
    perm = torch.argsort(key, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, key, torch.ones(n, dtype=torch.int32, device=dev))
    offsets = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts[:E], 0)
    xs = x2[ft[perm]]                                      # (n, D)
    if cfg.moe_wire_dtype == "int8":
        xs = _int8_wire(xs)

    # ---- grouped expert FFN ------------------------------------------------
    h = grouped_mm_swiglu(xs, p["w1"], offsets)            # (n, F)
    ye = grouped_mm(h, p["w2"], offsets)                   # (n, D)
    if cfg.moe_wire_dtype == "int8":
        ye = _int8_wire(ye)
    inv = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(n, device=dev))
    yp = ye[inv]                                           # flat order

    # ---- weighted combine: one fixed-order sum over k in fp32 --------------
    # dropped pairs' rows are exact zeros (the grouped GEMM zeroes rows past
    # offsets[E], and the int8 round trip keeps zeros), so they add nothing
    y = (yp.float().reshape(T, k, D) * fw.reshape(T, k, 1)).sum(1)
    return y.to(x.dtype).reshape(B, S, D), logits, probs, top_e


def _n_kept(n: int, cfg) -> int:
    """Pairs kept of ``n``: ``cap = ceil(T*k/n_pes*capacity_factor)`` at
    n_pes = 1."""
    return min(math.ceil(n * cfg.capacity_factor), n)


def moe_capacity(cfg, n_pes: int, tokens: int) -> int:
    """Pairs a PE takes for each owner PE in one grid MoE layer of
    ``tokens`` tokens: ``ceil(T k / n_pes * capacity_factor)``."""
    return int(math.ceil(tokens * cfg.top_k / n_pes * cfg.capacity_factor))


def _moe_grid(pctx: ParallelContext, p: Dict[str, torch.Tensor],
              x: torch.Tensor, cfg, metrics: bool = False):
    """The MoE block on one PE of a grid: x (B, S, D/r) -> y of the same
    shape, and with ``metrics`` also {moe_aux, moe_dropped} as the JAX
    block computes them (the load-balance fractions and mean probabilities
    averaged over the grid rows before their product; the z-loss and the
    dropped share of this PE's tokens).  ``p``: router (D, E) fp32 whole,
    w1 (E_loc, D, 2F) and w2 (E_loc, F, D) this PE's experts.

      * router logits: this PE's feature rows of the router (block j, or
        ``(i + j) % q`` under ``skewed``) against x in fp32, summed over
        the columns, so every PE of a row routes alike; softmax, top-k,
        renorm;
      * each pair's rank among the pairs bound for its owner PE ``e //
        E_loc``, kept below ``cap = ceil(T k / n_pes * capacity_factor)``;
      * send buffers (n_pes, cap, D/r) of this PE's feature slice and
        (n_pes, cap) of local expert ids, flat ``all_to_all``; the int8
        wire sends codes and scales of the rows instead, both ways;
      * full-D rows from the r column slices each source row sent (under
        ``skewed`` source row i's slices rolled back by i first), sorted
        by local expert, ``grouped_mm_swiglu`` and ``grouped_mm`` over the
        PE's E_loc experts, unsorted; the exchange back;
      * each pair's row by (owner, rank), dropped pairs zero, and the fp32
        combine over k in its fixed order.

    Slots no pair filled carry the id E_loc: they sort past
    ``offsets[E_loc]``, where the grouped GEMM writes zeros (the JAX block
    feeds them to expert 0 as zero rows, whose outputs are zeros too).

    In training the block is differentiable as it stands: the exchanges'
    backward is the exchange back (``PeGrid.all_to_all`` is its own
    transpose), the router's column psum a psum, the grouped GEMMs' dgrad
    and wgrad kernels run on this PE's experts, and the scatters write
    into fresh buffers, so every PE records the same graph."""
    grid = pctx.grid
    n_pes, q, r = grid.n_pes, grid.q, grid.r
    B, S, D_loc = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // n_pes
    n = T * k
    cap = moe_capacity(cfg, n_pes, T)
    dev = x.device
    i, j = grid.my_coords()
    skewed = pctx.act_layout == "skewed"
    fb = (i + j) % q if skewed else j

    x2 = x.reshape(T, D_loc)
    wr = p["router"][fb * D_loc:(fb + 1) * D_loc]
    logits = grid.psum_cols(x2.float() @ wr.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if cfg.router_renorm:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- dispatch bookkeeping (identical on every PE) ----------------------
    fe = top_e.reshape(n)
    fw = top_w.reshape(n).float()
    ft = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(n)
    dest = fe // E_loc
    oh = torch.nn.functional.one_hot(dest, n_pes).to(torch.int32)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)          # exclusive rank
    valid = pos < cap
    slot = torch.where(valid, pos, cap)                      # cap: dropped
    grid.note_drops(n, (~valid).sum())

    send_x = torch.zeros((n_pes, cap + 1, D_loc), dtype=x.dtype, device=dev)
    send_x[dest, slot] = x2[ft]
    send_le = torch.full((n_pes, cap + 1), E_loc, dtype=torch.int32,
                         device=dev)
    send_le[dest, slot] = (fe % E_loc).to(torch.int32)
    send_x, send_le = send_x[:, :cap], send_le[:, :cap]

    int8_wire = cfg.moe_wire_dtype == "int8"

    def exchange(t: torch.Tensor) -> torch.Tensor:
        """(n_pes, cap, ...) out and the blocks received back, in x's
        dtype; int8 codes and fp32 scales on the wire with the int8
        option."""
        if not int8_wire:
            return grid.all_to_all(t)
        q8, sc = _quantise(t)
        return (grid.all_to_all(q8).float() * grid.all_to_all(sc)).to(
            t.dtype)

    recv_x = exchange(send_x)                                # (n_pes, cap, Dl)
    recv_le = grid.all_to_all(send_le)
    # source PE (i_s, j_s) sent columns j_s of row i_s's tokens: the r
    # slices of a source row make full-D rows
    xs = recv_x.reshape(q, r, cap, D_loc)
    if skewed:      # source row i sent feature blocks (i + j) % q
        xs = torch.stack([torch.roll(xs[s], s, dims=0) for s in range(q)])
    xs = xs.transpose(1, 2).reshape(q * cap, r * D_loc)
    les = recv_le.reshape(q, r, cap)[:, 0].reshape(q * cap).long()

    # ---- this PE's experts: sort, two grouped GEMMs, unsort -----------------
    M = q * cap
    perm = torch.argsort(les, stable=True)
    counts = torch.zeros(E_loc + 1, dtype=torch.int32, device=dev
                         ).scatter_add_(0, les, torch.ones(
                             M, dtype=torch.int32, device=dev))
    offsets = torch.zeros(E_loc + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts[:E_loc], 0)
    h = grouped_mm_swiglu(xs[perm], p["w1"], offsets)        # (M, F)
    ye = grouped_mm(h, p["w2"], offsets)                     # (M, D)
    ys = torch.empty_like(ye)
    ys[perm] = ye

    # ---- the exchange back and the combine ---------------------------------
    yd = ys.reshape(q, cap, r, D_loc).transpose(1, 2)
    if skewed:      # each destination row's skewed slice order
        yd = torch.stack([torch.roll(yd[s], -s, dims=0) for s in range(q)])
    yd = yd.reshape(n_pes, cap, D_loc)
    back = exchange(yd)                                      # (n_pes, cap, Dl)
    got = back[dest, slot.clamp(max=cap - 1)]                # (n, D_loc)
    got = torch.where(valid[:, None], got, torch.zeros((), dtype=got.dtype,
                                                       device=dev))
    y = (got.float().reshape(T, k, D_loc) * fw.reshape(T, k, 1)).sum(1)
    y = y.to(x.dtype).reshape(B, S, D_loc)
    if not metrics:
        return y
    # the load balance over every token shard: fractions and mean
    # probabilities averaged over the grid rows (one psum of both) before
    # their product
    frac = torch.zeros(E, dtype=torch.float32, device=dev).scatter_add_(
        0, fe, torch.ones(n, dtype=torch.float32, device=dev)) / n
    both = grid.psum_rows(torch.stack([frac, probs.mean(0)])) / q
    aux = E * torch.sum(both[0] * both[1]) * cfg.moe_aux_coef
    zloss = torch.mean(torch.logsumexp(logits, -1) ** 2) * cfg.moe_z_coef
    return y, {"moe_aux": aux + zloss,
               "moe_dropped": (~valid).sum().float() / n}


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """The serving path's block: x (B, S, D) -> y, no metrics; with a
    grid ``pctx`` the grid form (:func:`_moe_grid`)."""
    if pctx is not None and not pctx.local:
        return _moe_grid(pctx, p, x, cfg)
    return _moe(p, x, cfg)[0]


def moe_metrics(logits: torch.Tensor, probs: torch.Tensor,
                top_e: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The switch-style load-balance loss plus the router z-loss
    (``moe_aux``) and the share of dropped pairs (``moe_dropped``)."""
    E = cfg.n_experts
    n = top_e.numel()
    hits = torch.zeros(E, dtype=torch.float32, device=top_e.device
                       ).scatter_add_(0, top_e.reshape(n), torch.ones(
                           n, dtype=torch.float32, device=top_e.device))
    aux = E * torch.sum(hits / n * probs.mean(0)) * cfg.moe_aux_coef
    zloss = torch.mean(torch.logsumexp(logits, -1) ** 2) * cfg.moe_z_coef
    dropped = torch.full((), (n - _n_kept(n, cfg)) / n, dtype=torch.float32,
                         device=top_e.device)
    return {"moe_aux": aux + zloss, "moe_dropped": dropped}


def moe_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
              pctx: Optional[ParallelContext] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (y same shape and dtype, metrics {moe_aux,
    moe_dropped}).  Serving calls ``moe_ffn``, which skips the metrics;
    training reads them.  With a grid ``pctx``, the grid form
    (:func:`_moe_grid`) on this PE's block."""
    if pctx is not None and not pctx.local:
        return _moe_grid(pctx, p, x, cfg, metrics=True)
    y, logits, probs, top_e = _moe(p, x, cfg)
    return y, moe_metrics(logits, probs, top_e, cfg)
