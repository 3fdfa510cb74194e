"""Serving step bodies on one device: the engine's over the paged KV arena,
and the fixed-batch decode path over a contiguous cache.

The counterparts of ``repro.serve.decode``'s ``make_decode_body(per_slot=
True, paged=...)`` and ``make_prefill_chunk_body``.  On one device (no
``pctx``, or a local one) every SHMEM row/column collective is the
identity, page routing ``p % q`` is trivial, and each gemv2d projection is
one ``torch.matmul``.  On one PE of a ``q x r`` grid of PE processes
(``pctx`` holding its :class:`~repro_torch.core.pe_grid.PeGrid`) each piece
takes its grid form, as in ``repro/serve/decode.py:343-449, 560-590``:
the embedding sums this row's vocabulary block over the rows, every
projection is a gemv2d, the norms add their statistics over the columns,
K/V are written on the page's owner row only (the other rows write
scratch), the paged kernel scores this row's pages (``row=i, qrows=q``)
and the row partials merge with the LSE rule, and the lm_head's vocabulary
blocks are gathered over the columns, for the last position only at
prefill.  :func:`grid_messages` reckons every message such a step puts
into the heaps.  The fixed-batch path (``make_decode_step`` without
``paged``, ``cache_specs`` and ``make_prefill``, at the end of this
module) is described there.

Both bodies read and write ONE state arena: a list with one entry per
pattern position.  An attention entry is ``{"k", "v"}`` of shape
``(G, n_blocks, stride, kvh, hd)``, addressed through per-slot block tables
``(B, s_max // stride)`` of physical page ids (-1 = unallocated).  A mamba
entry is ``{"conv", "ssm"}`` of shape ``(G, n_slots) + per-slot shape``,
addressed through a per-lane ``slots`` vector (B,) of dense slot ids (-1 =
idle lane).  The operands follow the StateSpec list, as in the JAX bodies:
``table`` when any layer pages KV, ``slots`` when any layer is dense.  The
arena is updated **in place** (the JAX bodies return a new arena that the
engine donates through every enqueue; here the new state is written into
the same storage), so the bodies return only the logits.

Every write has a fixed shape, so a body holds no host sync and no
data-dependent shape and can be captured as a CUDA graph: the last page
of a paged leaf and the last row of a dense leaf are **scratch**, which
no block table and no slot vector names (``StateStore`` allocates them
past the pool).  Writes the JAX bodies drop (``.at[].set(mode="drop")``)
land there: the K/V of padding columns, of idle slots and of positions
whose table entry is unallocated, and the state of idle lanes.  Nothing
reads scratch.

For an attention layer a one-position decode step is the L = 1 case of the
chunked-prefill path with every lane valid: the same RoPE, K/V write,
masked paged attention and logits, so the port keeps one attention path
where the JAX package has ``_attn_decode_paged`` and
``_attn_prefill_chunk_paged``.  A mamba layer is different: decode runs
``mamba_decode_step`` (an fp32 conv over the window and the one-token SSD
recurrence), exactly what the JAX decode body runs, and only chunk
launches run the chunked SSD scan and its kernels.  The two differ in
bf16 rounding, so a decode step is not an L = 1 chunk there.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import torch

from repro_torch.core.cannon import matmul_f32, unskew_activation
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import (attention_partial, combine_partials,
                                          cross_kv)
from repro_torch.models.config import (ModelConfig, attn_static,
                                       pad_to_multiple)
from repro_torch.models.layers import (ParallelContext, apply_norm,
                                       apply_rope, dense, fused_dense,
                                       mlp_apply, rms_norm_local,
                                       rope_tables)
from repro_torch.models.moe import moe_capacity, moe_ffn
from repro_torch.models.ssm import mamba_chunk_step, mamba_decode_step
from repro_torch.models.transformer import encode, forward


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Physically paged KV arena layout: ``n_blocks`` pages of
    ``block_pos_stride`` cache positions each, shared by every batch
    bucket.  Sequence identity lives entirely in host-built block tables,
    so slot migration, prefix sharing and ``fork()`` never touch the
    device KV."""

    n_blocks: int                # physical pages in the arena
    block_pos_stride: int        # cache positions per page

    def __post_init__(self):
        if self.n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        if self.block_pos_stride < 1:
            raise ValueError("block_pos_stride must be >= 1")


# ---------------------------------------------------------------------------
# Pieces of the bodies.
# ---------------------------------------------------------------------------

def _embed_decode(embed: torch.Tensor, tokens: torch.Tensor, compute_dtype,
                  pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """tokens (B,) or (B, L) -> (B, 1, D) or (B, L, D); ids outside the
    (padded) vocabulary embed to zero.  On a grid ``embed`` is this PE's
    (V/q, D/r) block: each row looks up the ids of its vocabulary block,
    and a row psum adds the blocks (``repro/serve/decode.py:560``); in the
    blocked layout (the batched decode) a row reduce-scatter adds them
    and gives grid row i batch chunk i, (B/q, 1, D/r)."""
    V = embed.shape[0]
    if pctx is not None and not pctx.local:
        tokens = tokens - pctx.grid.my_coords()[0] * V
    hit = (tokens >= 0) & (tokens < V)
    x = embed[tokens.clamp(0, V - 1).long()]
    x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    x = x.to(compute_dtype)
    if pctx is not None and pctx.blocked:
        return pctx.grid.reduce_scatter_rows(x, axis=0)[:, None, :]
    if pctx is not None and not pctx.local:
        x = pctx.grid.psum_rows(x)
    return x if tokens.ndim == 2 else x[:, None, :]


def _last_logits(lm_head: torch.Tensor, x: torch.Tensor,
                 pctx: Optional[ParallelContext] = None,
                 gather_rows: bool = False) -> torch.Tensor:
    """x (B, n, D) -> logits (B, n, Vpad) in fp32, the JAX package's
    fp32-accumulated ``out_dtype=float32`` gemv; a bf16 product would round
    the logits to bf16 (:func:`repro_torch.core.cannon.matmul_f32`).  On a
    grid the projection (gemv2d, or the strategy's GEMM in the blocked
    layout) gives this column's vocabulary block, and the blocks are
    gathered over the columns, then with ``gather_rows`` the rows' batch
    chunks over the rows (``repro/serve/decode.py:579-589``)."""
    if pctx is not None and not pctx.local:
        logits = dense(pctx, x, lm_head, out_dtype=torch.float32)
        logits = pctx.grid.all_gather_cols(logits, axis=-1)
        if gather_rows:
            logits = pctx.grid.all_gather_rows(logits, axis=0)
        return logits
    return matmul_f32(x, lm_head)


def _write_index(table: torch.Tensor, pos2: torch.Tensor,
                 n_valid: torch.Tensor, stride: int, scratch: int,
                 row: int = 0, qrows: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset), each (B, L), of every K/V position a launch writes:
    a valid chunk column (``j < n_valid``) writes its table page (the
    entry clipped to the table, as in the JAX body), and a padding column,
    an idle slot (table -1) or an unallocated entry writes the ``scratch``
    page instead.  On grid row ``row`` of ``qrows`` only the pages this
    row owns are written, at their local index ``p // qrows``; a page of
    another row is scratch here.  Computed once per launch and shared by
    every layer."""
    B, T = table.shape
    L = pos2.shape[1]
    valid = torch.arange(L, device=pos2.device)[None, :] < n_valid[:, None]
    tidx = (pos2 // stride).clamp(0, T - 1).long()
    pid = torch.gather(table, 1, tidx)
    if qrows == 1:
        page = torch.where(valid & (pid >= 0), pid, scratch).long()
    else:
        mine = valid & (pid >= 0) & (pid % qrows == row)
        page = torch.where(mine, pid // qrows, scratch).long()
    return page, (pos2 % stride).long()


def _attn_prefill_chunk_paged(p, x, cfg, kc, vc, rope, pos2, widx, table,
                              stride, pctx=None):
    """Chunked-prefill attention against the paged arena.

    x (B, L, D): slot b advances positions ``pos2[b]``; kc/vc
    (n_blocks, stride, kvh, hd) are this layer's arena pages, written in
    place.  Head counts come from the weight shapes, and query head h
    reads kv head ``h // (Hq / kvh)``.  On a grid x is (B, L, D/r), the
    heads are this column's, the pages this row's."""
    ast = attn_static(cfg)
    B, L = x.shape[:2]
    hd = ast.head_dim
    q, k, v = fused_dense(pctx, x, [p["wq"], p["wk"], p["wv"]],
                          biases=[p["bq"], p["bk"], p["bv"]]
                          if ast.qkv_bias else None)
    q = q.reshape(B, L, -1, hd)
    k = k.reshape(B, L, -1, hd)
    v = v.reshape(B, L, -1, hd)
    if ast.qk_norm:
        q = rms_norm_local(q, p["q_norm"])
        k = rms_norm_local(k, p["k_norm"])
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    kc.index_put_(widx, k.to(kc.dtype))
    vc.index_put_(widx, v.to(vc.dtype))

    row, qrows = (0, 1) if pctx is None or pctx.local \
        else (pctx.grid.my_coords()[0], pctx.q)
    part = paged_attention(q.transpose(1, 2).contiguous(), kc, vc, table,
                           pos2, stride=stride, row=row, qrows=qrows)
    out = combine_partials(part, pctx)                # (B, Hq, L, hd) fp32
    out = out.transpose(1, 2).reshape(B, L, -1)
    return dense(pctx, out.to(x.dtype), p["wo"])


def _unstack(tree, n: int) -> List:
    """Split every leaf's leading group dim: n trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _dense_index(slots: torch.Tensor, scratch: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather, scatter) rows of every lane in the slot arena: an idle lane
    (slot -1) reads slot 0 as a dummy and writes the ``scratch`` row (the
    JAX body routes it out of bounds with ``mode="drop"``).  Computed once
    per launch and shared by every dense layer."""
    return (slots.clamp(min=0).long(),
            torch.where(slots >= 0, slots, scratch).long())


def _dense_slot_gather(cache, idx: torch.Tensor):
    """Each lane's dense state rows from the slot arena (leaves
    ``(n_slots + 1, ...)``)."""
    return {name: a[idx] for name, a in cache.items()}


def _dense_slot_scatter(cache, new, idx: torch.Tensor) -> None:
    """Write every lane's advanced state back to its row, in place."""
    for name, a in cache.items():
        a[idx] = new[name].to(a.dtype)


class _Operands(NamedTuple):
    """What every layer of one launch shares."""
    stride: int
    n_valid: torch.Tensor
    decode: bool                          # mamba layers: one-token step
    rope: Optional[Tuple] = None          # paged layers
    pos2: Optional[torch.Tensor] = None
    widx: Optional[Tuple] = None
    table: Optional[torch.Tensor] = None
    dense: Optional[Tuple] = None         # dense layers: _dense_index
    pctx: Optional[ParallelContext] = None    # a PE of a grid


def _decode_layer(cfg, mixer, ffn, p, x, cache, op: _Operands):
    h = apply_norm(cfg, p["norm1"], x, op.pctx)
    if mixer == "attn":
        x = x + _attn_prefill_chunk_paged(p["mixer"], h, cfg, cache["k"],
                                          cache["v"], op.rope, op.pos2,
                                          op.widx, op.table, op.stride,
                                          op.pctx)
    elif mixer in ("mamba", "ssm"):
        st = _dense_slot_gather(cache, op.dense[0])
        state = (st["conv"], st["ssm"])
        if op.decode:
            h, (conv, ssm) = mamba_decode_step(p["mixer"], h, state, cfg,
                                               op.pctx)
        else:
            h, (conv, ssm) = mamba_chunk_step(p["mixer"], h, state, cfg,
                                              op.n_valid, op.pctx)
        x = x + h
        _dense_slot_scatter(cache, {"conv": conv, "ssm": ssm}, op.dense[1])
    else:
        raise NotImplementedError(f"mixer {mixer!r}")
    if ffn == "mlp":
        h = apply_norm(cfg, p["norm2"], x, op.pctx)
        x = x + mlp_apply(cfg, p["ffn"], h, op.pctx)
    elif ffn == "moe":
        h = apply_norm(cfg, p["norm2"], x, op.pctx)
        x = x + moe_ffn(p["ffn"], h, cfg, op.pctx)
    elif ffn != "none":
        raise NotImplementedError(f"({mixer}, {ffn}) layers")
    return x


def _run(cfg: ModelConfig, params, arena, tokens, pos, n_valid, table,
         slots, *, stride: int, decode: bool, all_logits: bool,
         pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    B, L = tokens.shape
    G = cfg.n_groups()
    pattern = cfg.pattern()
    if pctx is not None and pctx.local:
        pctx = None
    x = _embed_decode(params["embed"], tokens, cfg.compute_dtype, pctx)
    op = _Operands(stride=stride, n_valid=n_valid, decode=decode, pctx=pctx)
    if any(m == "attn" for m, _ in pattern):
        pos2 = (pos[:, None] + torch.arange(L, dtype=torch.int32,
                                            device=pos.device)[None, :])
        scratch = next(e["k"].shape[1] for e in arena if "k" in e) - 1
        row, qrows = (0, 1) if pctx is None \
            else (pctx.grid.my_coords()[0], pctx.q)
        op = op._replace(rope=rope_tables(pos2, cfg.hd(), cfg.rope_theta),
                         pos2=pos2, widx=_write_index(table, pos2, n_valid,
                                                      stride, scratch, row,
                                                      qrows),
                         table=table)
    if any(m in ("mamba", "ssm") for m, _ in pattern):
        scratch = next(e["ssm"].shape[1] for e in arena if "ssm" in e) - 1
        op = op._replace(dense=_dense_index(slots, scratch))
    layers = [_unstack(lp, G) for lp in params["layers"]]
    caches = [_unstack(c, G) for c in arena]
    for g in range(G):
        for posn, (mixer, ffn) in enumerate(pattern):
            x = _decode_layer(cfg, mixer, ffn, layers[posn][g], x,
                              caches[posn][g], op)
    if not all_logits:
        # each slot's last VALID chunk position, before the final norm and
        # lm_head (both pointwise over positions, so the gather commutes)
        idx = (n_valid - 1).clamp(0, L - 1).long()
        x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[-1]))
    x = apply_norm(cfg, params["final_norm"], x, pctx)
    return _last_logits(params["lm_head"], x, pctx)


# ---------------------------------------------------------------------------
# The two step bodies.
# ---------------------------------------------------------------------------

def prefill_chunk_step(cfg: ModelConfig, params, arena, tokens: torch.Tensor,
                       pos: torch.Tensor, n_valid: torch.Tensor,
                       table: Optional[torch.Tensor] = None,
                       slots: Optional[torch.Tensor] = None, *, stride: int,
                       all_logits: bool = False,
                       pctx: Optional[ParallelContext] = None
                       ) -> torch.Tensor:
    """The ``prefill_bs{N}_len{L}`` body: up to L tokens per slot per launch.

    tokens (B, L), pos (B,), n_valid (B,), table (B, T) when any layer
    pages KV, slots (B,) when any layer is dense, all int32.  Slot b
    consumes ``tokens[b, :n_valid[b]]`` at cache positions
    ``[pos[b], pos[b] + n_valid[b])``: its K/V scatter into its block-table
    pages and the blocked causal mask makes chunk position j attend to
    exactly [0, pos + j], and its dense state advances through the valid
    prefix in one :func:`mamba_chunk_step`.  Returns fp32 logits
    ``(B, 1, Vpad)`` of each slot's last valid position, or ``(B, L, Vpad)``
    with ``all_logits`` (the speculative-verify variant).  ``arena`` is
    updated in place.  ``pctx`` runs it as one PE of a grid."""
    return _run(cfg, params, arena, tokens, pos, n_valid, table, slots,
                stride=stride, decode=False, all_logits=all_logits,
                pctx=pctx)


def decode_step(cfg: ModelConfig, params, arena, tokens: torch.Tensor,
                pos: torch.Tensor, table: Optional[torch.Tensor] = None,
                slots: Optional[torch.Tensor] = None, *, stride: int,
                pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """The ``serve_step_bs{N}`` body: every slot advances one position.

    tokens (B,), pos (B,), table (B, T) and/or slots (B,) int32 -> fp32
    logits (B, 1, Vpad).  Idle slots carry an all -1 table row and slot -1,
    and write only scratch."""
    return _run(cfg, params, arena, tokens[:, None], pos,
                torch.ones_like(pos), table, slots, stride=stride,
                decode=True, all_logits=False, pctx=pctx)


class Message(NamedTuple):
    """One collective's message in a grid step: its name, the bytes of the
    block each PE puts, and how many puts of it each PE makes."""
    what: str
    nbytes: int
    puts: int


def grid_messages(cfg: ModelConfig, plan, batch: int, length: int, *,
                  hq: int, kvh: int, all_logits: bool = False
                  ) -> List[Message]:
    """Every message one step puts into the heaps on ``plan``'s grid, in
    the order the body sends them: ``batch`` slots of ``length`` positions
    (1 for a decode step), this PE's ``hq`` q heads and ``kvh`` kv heads.
    A gemv2d is a transpose put (one put of the compute-dtype input) and a
    row psum (q puts of the fp32 partial); a row or column collective puts
    its block to each of the group's q or r members; a flat exchange puts
    one block to each of the n_pes PEs.  A mamba layer: the norm, its five
    in-projections as one gemv2d, B and C gathered over the columns, the
    gated norm and ``wo``.  An MoE layer: the norm, the router's column
    psum, then the tokens' rows and their local expert ids out and the rows
    back, each as a flat exchange of ``cap`` rows a PE (the int8 wire: the
    codes and their fp32 scales each way).  The largest ``nbytes`` sizes
    the heap's slots, and ``n_pes * sum(nbytes * puts)`` is the step's heap
    traffic, which the grid counts as ``heap_bytes``."""
    q, r = plan.grid_q, plan.grid_r
    n_pes = q * r
    esz = torch.empty((), dtype=cfg.compute_dtype).element_size()
    hd = cfg.hd()
    D, F = cfg.d_model // r, cfg.d_ff // r
    V = pad_to_multiple(cfg.vocab_size, q * r) // r
    n = batch * length
    stats = 2 if cfg.norm == "layernorm" else 1

    def gemv(tag, k, n_out, rows=n):
        return [Message(f"{tag} put", rows * k * esz, 1),
                Message(f"{tag} psum_rows", rows * n_out * 4, q)]

    def rows_out(tag, cap, width):
        """A flat exchange of ``cap`` rows of ``width`` compute-dtype
        features to every PE (int8 codes and fp32 scales on the int8
        wire)."""
        if cfg.moe_wire_dtype == "int8":
            return [Message(f"{tag} all_to_all int8", cap * width, n_pes),
                    Message(f"{tag} all_to_all scales", cap * 4, n_pes)]
        return [Message(f"{tag} all_to_all", cap * width * esz, n_pes)]

    out = [Message("embed psum_rows", n * D * esz, q)]
    for mixer, ffn in cfg.pattern():
        layer = [Message("norm1 psum_cols", n * stats * 4, r)]
        if mixer == "attn":
            layer += gemv("qkv", D, (hq + 2 * kvh) * hd)
            layer += [Message("attn pmax_rows", batch * hq * length * 4, q),
                      Message("attn psum_rows",
                              batch * hq * length * (hd + 1) * 4, q)]
            layer += gemv("wo", hq * hd, D)
        else:
            di, H = cfg.d_inner // r, cfg.ssm_heads // r
            gn = cfg.ssm_groups * cfg.ssm_state // r
            layer += gemv("in_proj", D, 2 * di + 2 * gn + H)
            layer += [Message("B all_gather_cols", n * gn * esz, r),
                      Message("C all_gather_cols", n * gn * esz, r),
                      Message("ssm_norm psum_cols", n * 4, r)]
            layer += gemv("wo", di, D)
        if ffn == "mlp":
            layer.append(Message("norm2 psum_cols", n * stats * 4, r))
            layer += gemv("gate_up", D, (2 if cfg.act == "swiglu" else 1)
                          * F)
            layer += gemv("down", F, D)
        elif ffn == "moe":
            cap = moe_capacity(cfg, n_pes, n)
            layer.append(Message("norm2 psum_cols", n * stats * 4, r))
            layer.append(Message("router psum_cols", n * cfg.n_experts * 4,
                                 r))
            layer += rows_out("moe rows", cap, D)
            layer.append(Message("moe expert ids all_to_all", cap * 4,
                                 n_pes))
            layer += rows_out("moe rows back", cap, D)
        out += layer * cfg.n_groups()
    last = batch * (length if all_logits else 1)
    out.append(Message("final psum_cols", last * stats * 4, r))
    out += gemv("lm_head", D, V, rows=last)
    out.append(Message("logits all_gather_cols", last * V * 4, r))
    return out


# ---------------------------------------------------------------------------
# The fixed-batch decode path: a contiguous cache, every slot one token a
# step.
# ---------------------------------------------------------------------------
#
# ``repro.serve.decode.make_decode_step`` without ``paged``, at q = r = 1.
# The JAX package lays the cache out three ways for its grid: ``batched``
# (batch over grid rows, Cannon projections), ``gemv`` (weights
# stationary, the cache's sequence over grid rows, flash-decoding merge)
# and ``longctx`` (the sequence over data x rows, batch replicated).  On one
# card every grid collective is the identity and every shard is the whole
# cache, so the three compute one function: each keeps its name and its
# argument checks, and nothing else of the grid is emulated.  Attention
# here is the plain ``attention_partial`` over the cache, as the JAX
# package computes it in jnp on every non-paged mode; MoE layers run the
# grouped GEMM on the card, as everywhere.  (The JAX ``gemv`` and
# ``longctx`` modes read no QKV bias, ``_attn_decode_longctx``; the port
# adds it in every mode, as JAX's ``batched`` does.  The two agree while
# the biases are zero, as their initializer makes them.)

DECODE_MODES = ("batched", "gemv", "longctx")

CacheEntry = Dict[str, torch.Tensor]


def _check_mode(mode: str, per_slot: bool = False) -> None:
    if mode not in DECODE_MODES:
        raise ValueError(f"mode must be one of {DECODE_MODES}, got {mode!r}")
    if per_slot and mode == "longctx":
        raise NotImplementedError(
            "per-slot decode needs a data-sharded batch dim "
            "(modes: batched, gemv)")


def _grid_pctx(pctx: Optional[ParallelContext], mode: str
               ) -> Optional[ParallelContext]:
    """``pctx`` when it is a grid of several PEs, else None; a grid runs
    the ``batched`` mode in the blocked layout only."""
    if pctx is None or pctx.local:
        return None
    if mode != "batched":
        raise NotImplementedError(
            f"the fixed-batch {mode!r} mode on a grid of PE processes comes "
            f"with a later slice (gemv/longctx fixed-batch on the grid); "
            f"the grid runs mode 'batched'")
    if not pctx.blocked or pctx.tp_strategy != "cannon":
        raise ValueError("the batched decode on a grid takes the Cannon "
                         "context of make_pctx(grid, 'cannon')")
    return pctx


def cache_specs(cfg: ModelConfig, batch: int, s_max: int, mode: str, *,
                kvh: Optional[int] = None, device=None,
                pctx: Optional[ParallelContext] = None) -> List[CacheEntry]:
    """The zeroed decode cache, one dict of leaves per pattern position,
    allocated on ``device`` (the card unless the caller asks for the CPU):
    ``repro.serve.decode.cache_specs`` at q = r = 1, where the three modes
    share one layout, filled with zeros as the JAX launcher fills it.  An
    attention position holds ``k``/``v`` ``(G, B, s_max, kvh, hd)`` and,
    for an encoder-decoder model, ``cross_k``/``cross_v`` ``(G, B, enc_seq,
    kvh, hd)``; a mamba position ``conv`` ``(G, B, k - 1, conv_ch)`` and
    ``ssm`` ``(G, B, H, N, P)`` fp32.  ``kvh`` is the stored kv-head count
    of the weights served (:func:`repro_torch.models.params.stored_heads`),
    by default the config's.  With a grid ``pctx`` (mode ``batched``) a
    PE's cache of ``repro/serve/decode.py:103-151``: its row's B/q slots,
    its column's kv heads (``kvh`` given as the grid stores them), conv
    channels and SSM heads."""
    _check_mode(mode)
    pctx = _grid_pctx(pctx, mode)
    dev = resolve_device(device)
    G, dt = cfg.n_groups(), cfg.compute_dtype
    q, r = (1, 1) if pctx is None else (pctx.q, pctx.r)
    if batch % q:
        raise ValueError(f"batch {batch} does not split over {q} grid rows")
    batch //= q

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    out = []
    for mixer, _ in cfg.pattern():
        if mixer == "attn":
            kv = (G, batch, s_max,
                  (kvh if kvh is not None else cfg.kv_stored(r)[0]) // r,
                  cfg.hd())
            e = {"k": zeros(kv), "v": zeros(kv)}
            if cfg.enc_layers:
                cross = (G, batch, cfg.enc_seq) + kv[3:]
                e.update(cross_k=zeros(cross), cross_v=zeros(cross))
        elif mixer in ("mamba", "ssm"):
            conv_ch = (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) // r
            e = {"conv": zeros((G, batch, cfg.conv_kernel - 1, conv_ch)),
                 "ssm": zeros((G, batch, cfg.ssm_heads // r, cfg.ssm_state,
                               cfg.ssm_headdim), torch.float32)}
        else:
            raise NotImplementedError(f"no decode cache for mixer {mixer!r}")
        out.append(e)
    return out


def _group(cache: List[CacheEntry], g: int) -> List[CacheEntry]:
    """Every position's leaves at layer group g (views)."""
    return [{name: leaf[g] for name, leaf in e.items()} for e in cache]


@torch.no_grad()
def fill_cross_cache(cfg: ModelConfig, params, cache: List[CacheEntry],
                     frames: torch.Tensor) -> torch.Tensor:
    """Run the encoder over ``frames`` (B, enc_seq, D) and write every
    decoder layer's cross K/V into ``cross_k``/``cross_v``, in place: the
    K/V half of ``cross_attention_block`` (:func:`cross_kv`), applied per
    layer to the encoder output, which is returned."""
    if not cfg.enc_layers:
        raise ValueError(f"{cfg.name} has no encoder")
    enc = encode(cfg, params, frames)
    for pos, entry in enumerate(cache):
        lp = params["layers"][pos]
        if "cross" not in lp or "cross_k" not in entry:
            continue
        for g in range(cfg.n_groups()):
            k, v = cross_kv({n: t[g] for n, t in lp["cross"].items()}, enc,
                            cfg.hd())
            entry["cross_k"][g].copy_(k)
            entry["cross_v"][g].copy_(v)
    return enc


class _Fixed(NamedTuple):
    """What every layer of one fixed-batch step shares."""
    rope: Tuple[torch.Tensor, torch.Tensor]   # (B or 1, 1, hd/2) each
    q_pos: torch.Tensor                       # (1,) or (B, 1)
    write: Union[int, torch.Tensor]           # the cache row: int or (B,)


def _attn_decode_fixed(p, x, ast, kc, vc, op: _Fixed,
                       pctx: Optional[ParallelContext] = None):
    """One new token's attention over the contiguous cache (the JAX
    ``_attn_decode_batched``): x (B, 1, D); kc/vc (B, s_max, kvh, hd) are
    written in place at each slot's position, then every cached position
    at or before it is attended to.  With a blocked grid ``pctx`` x is
    this PE's (B/q, 1, D/r) block, the cache its rows' slots and its
    column's kv heads, and the projections the strategy's GEMMs; the
    attention itself needs no communication."""
    B = x.shape[0]
    hd = ast.head_dim
    if pctx is not None:
        q, k, v = fused_dense(pctx, x, [p["wq"], p["wk"], p["wv"]], biases=[
            p["bq"], p["bk"], p["bv"]] if ast.qkv_bias else None)
    else:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if ast.qkv_bias:
            q = q + p["bq"].to(q.dtype)
            k = k + p["bk"].to(k.dtype)
            v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, 1, -1, hd)
    k = k.reshape(B, 1, -1, hd)
    v = v.reshape(B, 1, -1, hd)
    if ast.qk_norm:
        q = rms_norm_local(q, p["q_norm"])
        k = rms_norm_local(k, p["k_norm"])
    cos, sin = op.rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if isinstance(op.write, int):
        kc[:, op.write] = k[:, 0].to(kc.dtype)
        vc[:, op.write] = v[:, 0].to(vc.dtype)
    else:
        lanes = torch.arange(B, device=x.device)
        kc[lanes, op.write] = k[:, 0].to(kc.dtype)
        vc[lanes, op.write] = v[:, 0].to(vc.dtype)
    S = kc.shape[1]
    part = attention_partial(q.transpose(1, 2), kc.transpose(1, 2),
                             vc.transpose(1, 2),
                             kv_pos=torch.arange(S, device=x.device),
                             q_pos=op.q_pos)
    out = combine_partials(part).transpose(1, 2).reshape(B, 1, -1)
    if pctx is not None:
        return dense(pctx, out.to(x.dtype), p["wo"])
    return out.to(x.dtype) @ p["wo"]


def _cross_decode(p, x, ast, ck, cv):
    """Cross attention of one new token against the cached encoder K/V
    (the JAX ``_cross_decode``): ck/cv (B, enc_seq, kvh, hd), no mask."""
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, -1, ast.head_dim)
    zero = torch.zeros(1, dtype=torch.int32, device=x.device)
    part = attention_partial(q.transpose(1, 2), ck.transpose(1, 2),
                             cv.transpose(1, 2),
                             kv_pos=zero.expand(ck.shape[1]), q_pos=zero)
    out = combine_partials(part).transpose(1, 2).reshape(B, 1, -1)
    return out.to(x.dtype) @ p["wo"]


def _fixed_layer(cfg, mixer, ffn, p, x, cache: CacheEntry, op: _Fixed,
                 pctx: Optional[ParallelContext] = None):
    """One layer of the fixed-batch step (the JAX ``_decode_layer`` on its
    non-paged branches), its cache entry updated in place; with a blocked
    grid ``pctx`` on this PE's blocks."""
    h = apply_norm(cfg, p["norm1"], x, pctx)
    if mixer == "attn":
        x = x + _attn_decode_fixed(p["mixer"], h, attn_static(cfg),
                                   cache["k"], cache["v"], op, pctx)
    elif mixer in ("mamba", "ssm"):
        h, (conv, ssm) = mamba_decode_step(p["mixer"], h, (cache["conv"],
                                                           cache["ssm"]), cfg,
                                           pctx)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        x = x + h
    else:
        raise NotImplementedError(f"mixer {mixer!r}")
    if "cross" in p:
        h = apply_norm(cfg, p["norm_cross"], x)
        x = x + _cross_decode(p["cross"], h, attn_static(cfg),
                              cache["cross_k"], cache["cross_v"])
    if ffn == "mlp":
        x = x + mlp_apply(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x, pctx),
                          pctx)
    elif ffn == "moe":
        x = x + moe_ffn(p["ffn"], apply_norm(cfg, p["norm2"], x, pctx), cfg,
                        pctx)
    elif ffn != "none":
        raise NotImplementedError(f"({mixer}, {ffn}) layers")
    return x


def _fixed_operands(cfg, pos, B: int, s_max: int, device) -> _Fixed:
    """RoPE tables, query positions and cache rows of one step: ``pos`` a
    scalar (every slot at one position; an int or a 0-d tensor) or a (B,)
    tensor.  The cache row is the position clamped into the cache, as the
    JAX writes (a dynamic slice, a clipped one-hot) clamp it."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=device, dtype=torch.int32)
        if pos.shape[0] != B:
            raise ValueError(f"per-slot pos must be ({B},), got "
                             f"{tuple(pos.shape)}")
        cos, sin = rope_tables(pos[:, None], cfg.hd(), cfg.rope_theta)
        return _Fixed((cos, sin), pos[:, None],
                      pos.clamp(0, s_max - 1).long())
    t = int(pos)
    posv = torch.full((1,), t, dtype=torch.int32, device=device)
    cos, sin = rope_tables(posv, cfg.hd(), cfg.rope_theta)
    return _Fixed((cos[None], sin[None]), posv, min(max(t, 0), s_max - 1))


def make_decode_step(cfg: ModelConfig, *, batch: int, s_max: int,
                     mode: str = "batched", per_slot: bool = False,
                     pctx: Optional[ParallelContext] = None) -> Callable:
    """``step(params, cache, tokens, pos[, reset]) -> logits``: the
    fixed-batch decode step (``repro.serve.decode.make_decode_step``
    without ``paged``; the engine's paged step is :func:`decode_step`),
    run under ``torch.no_grad()``.

    tokens (B,) int; ``pos`` a scalar (every slot writes and attends at
    one position) or, with ``per_slot``, a (B,) tensor of each slot's
    position together with ``reset`` (B,): slots with ``reset > 0`` start
    from a zeroed cache (every leaf of the slot, as the JAX step wipes it
    inside the step).  ``longctx`` refuses ``per_slot``, as the JAX
    package does.  Returns fp32 logits (B, 1, Vpad); ``cache``
    (:func:`cache_specs`) is updated in place, so only the logits are
    returned.

    With a grid ``pctx`` (``make_pctx(grid, "cannon")``; mode ``batched``
    only, ``repro/serve/decode.py:591-742``) every PE takes the whole
    (B,) tokens and ``pos``/``reset``: the embedding's reduce-scatter
    gives grid row i batch chunk i, whose slots (``pos``, ``reset``) it
    keeps in its own cache (:func:`cache_specs` with the ``pctx``), the
    projections are Cannon GEMMs on pre-skewed blocks, attention and the
    mamba recurrence run on this PE's slots and heads with no
    communication, and the logits are gathered over the columns and the
    rows, so every PE returns all (B, 1, Vpad)."""
    _check_mode(mode, per_slot)
    pctx = _grid_pctx(pctx, mode)
    pattern = cfg.pattern()
    G = cfg.n_groups()
    q = 1 if pctx is None else pctx.q
    if batch % q:
        raise ValueError(f"batch {batch} does not split over {q} grid rows")
    b_loc = batch // q

    @torch.no_grad()
    def step(params, cache: List[CacheEntry], tokens: torch.Tensor, pos,
             reset: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tokens.shape != (batch,):
            raise ValueError(f"tokens must be ({batch},), got "
                             f"{tuple(tokens.shape)}")
        if per_slot != (reset is not None) or per_slot != (
                isinstance(pos, torch.Tensor) and pos.ndim == 1):
            raise ValueError("per_slot steps take a (B,) pos and a reset "
                             "vector; scalar steps take neither")
        dev = tokens.device
        if pctx is not None and per_slot:
            # this row's batch chunk, as the embedding's reduce-scatter
            # hands it out; the wipe reaches this PE's slots only
            i, _ = pctx.grid.my_coords()
            pos = pos[i * b_loc:(i + 1) * b_loc]
            reset = reset[i * b_loc:(i + 1) * b_loc]
        if reset is not None:
            wipe = reset.to(dev) > 0
            for e in cache:
                for leaf in e.values():
                    leaf.masked_fill_(
                        wipe.view((1, -1) + (1,) * (leaf.ndim - 2)), 0)
        op = _fixed_operands(cfg, pos, b_loc, s_max, dev)
        x = _embed_decode(params["embed"], tokens, cfg.compute_dtype, pctx)
        layers = [_unstack(lp, G) for lp in params["layers"]]
        for g in range(G):
            caches = _group(cache, g)
            for posn, (mixer, ffn) in enumerate(pattern):
                x = _fixed_layer(cfg, mixer, ffn, layers[posn][g], x,
                                 caches[posn], op, pctx)
        x = apply_norm(cfg, params["final_norm"], x, pctx)
        return _last_logits(params["lm_head"], x, pctx, gather_rows=True)

    return step


def make_prefill(cfg: ModelConfig, *,
                 extra_batch_keys: Sequence[str] = (),
                 pctx: Optional[ParallelContext] = None) -> Callable:
    """``prefill(params, batch) -> logits (B, 1, Vpad)`` fp32 of the last
    position (``repro.serve.decode.make_prefill``): the full
    training-style forward (:func:`repro_torch.models.transformer.forward`)
    under ``torch.no_grad()``, then the lm_head on the final position.
    ``batch`` holds ``tokens`` and each of ``extra_batch_keys`` (``frames``
    for an encoder-decoder model, ``patches`` for a vision-language one).

    With a blocked grid ``pctx`` (``make_pctx``, any strategy;
    ``repro/serve/decode.py:879-905``) the forward runs on this PE's
    blocks; the last position, held by grid row q-1, reaches every row by
    a masked ``psum_rows``, the lm_head GEMM takes it as a natural block
    (under cannon_opt it is unskewed first, one put, and the GEMM is the
    classic ``std`` one: the residual's skewed block of row q-1 is not the
    block another row's A-rotating GEMM expects), and the vocabulary is
    gathered over the columns: every PE returns all (B, 1, Vpad)."""
    keys = ("tokens",) + tuple(extra_batch_keys)
    grid = None if pctx is None or pctx.local else pctx
    if grid is not None and not grid.blocked:
        raise ValueError("prefill on a grid runs in the blocked layout "
                         "(make_pctx)")

    def prefill(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        missing = [k for k in keys if k not in batch]
        if missing:
            raise ValueError(f"prefill batch lacks {missing}")
        with torch.no_grad():
            x, _ = forward(cfg, params, {k: batch[k] for k in keys},
                           pctx=grid)
            if grid is None:
                return _last_logits(params["lm_head"], x[:, -1:])
            return _last_grid(grid, params["lm_head"], x[:, -1:])

    return prefill


def _last_grid(pctx: ParallelContext, lm_head: torch.Tensor,
               last: torch.Tensor) -> torch.Tensor:
    """Logits (B, 1, Vpad) of the sequence's last position from this PE's
    (B, 1, D/r) block of its rows' last positions (:func:`make_prefill`)."""
    grid = pctx.grid
    if pctx.act_layout == "skewed":
        last = unskew_activation(grid, last)
        pctx = pctx.with_(act_layout="blocked")
    i, _ = grid.my_coords()
    if i != pctx.q - 1:
        last = torch.zeros_like(last)
    last = grid.psum_rows(last)
    logits = dense(pctx, last, lm_head, out_dtype=torch.float32, kind="std")
    return grid.all_gather_cols(logits, axis=-1)
