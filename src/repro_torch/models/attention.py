"""Attention on one device: the training layer, encoder-decoder cross
attention, and the flash-decoding partials with their log-sum-exp merge.

``chunked_attention``, ``attention_block`` and ``cross_attention_block``
are the counterparts of ``repro.models.attention``'s at q = r = 1: the
K/V ``fcollect`` over grid rows is the identity, every head is local, and
the fused QKV projection is three ``torch.matmul`` calls.  The attention
is differentiable torch, as the JAX training path's is jnp (it reaches no
Pallas kernel): a running ``(m, l, acc)`` over ``block_kv`` key blocks,
each block recomputed in the backward (``torch.utils.checkpoint``), so the
S x S scores never live.

On one PE of a grid of PE processes in the blocked layout (a ``pctx``
whose ``blocked`` is set) :func:`attention_block_grid` is the JAX block
itself (``repro/models/attention.py:151-193``): the fused QKV projection
as one distributed GEMM, RoPE at the global positions of this PE's
sequence block, K/V gathered over the grid rows, ``chunked_attention``
with the block's query offset, and ``wo`` as the C-rotating GEMM (under
cannon_opt).

``attention_partial`` scores q against one run of keys with per-position
labels and returns the unnormalised softmax partials ``(m, l, acc)``;
``combine_partials`` merges them.  On one device the KV cache is not
sharded, so the SHMEM row reductions are the identity and the merge
reduces to ``acc / max(l, 1e-30)``; on a grid of PE processes the paged
arena's pages are spread over the grid rows and the merge takes the row
``pmax`` and ``psum``.

``NEG_INF`` stays finite: a row that has seen only masked keys keeps
``m = -1e30`` with ``exp(s - m) = 1``, which the merge then weighs to zero.
With ``-inf`` the same row would give NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (apply_rope, dense, fused_dense,
                                       rms_norm_local, rope_tables)

NEG_INF = -1e30


def _kv_block(q32, kc, vc, q_pos, kv_pos, causal, m_prev, l_prev, acc):
    """Fold one key block into the running (m, l, acc)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kc)
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + torch.sum(p, dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
    return m_new, l_new, acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True,
                      block_kv: int = 512) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype.

    Causal over global positions: query row i sits at ``q_offset + i``,
    key j at j.  GQA repeats each kv head over its ``Hq / Hkv`` query
    heads.  The key blocks are the largest divisor of Skv not above
    ``block_kv``; each is folded into fp32 ``(m, l, acc)`` (q scaled by
    D^-1/2) and recomputed
    in the backward when grad is on.  ``l`` is clamped at 1e-30 before the
    division, and masked scores are ``NEG_INF``."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    group = Hq // k.shape[1]
    bk = min(block_kv, Skv)
    while Skv % bk:          # largest divisor of Skv not exceeding block_kv
        bk -= 1
    q32 = q.float() * D ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for i in range(Skv // bk):
        sl = slice(i * bk, (i + 1) * bk)
        kv_pos = torch.arange(i * bk, (i + 1) * bk, device=q.device)
        args = (q32, kr[:, :, sl], vr[:, :, sl], q_pos, kv_pos, causal,
                m, l, acc)
        m, l, acc = (checkpoint(_kv_block, *args, use_reentrant=False)
                     if remat else _kv_block(*args))
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def attention_block(p: dict, x: torch.Tensor, cfg, pos_offset: int = 0
                    ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the full-sequence layer (training).

    ``cfg`` is an ``AttnStatic`` (head size, theta, qk_norm, qkv_bias,
    causal, block_kv); the head counts are read off the weights, so the
    stored geometry of weights carried over from a JAX grid (padded q
    heads, replicated kv heads) runs as it was stored.  The projections
    round to x's dtype before their biases are added, as the JAX block's
    fused GEMM does."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm_local(q, p["q_norm"])
        k = rms_norm_local(k, p["k_norm"])
    pos = pos_offset + torch.arange(S, device=x.device)
    cos, sin = rope_tables(pos, hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    out = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), q_offset=pos_offset,
                            causal=cfg.causal, block_kv=cfg.attn_block_kv)
    return out.transpose(1, 2).reshape(B, S, -1) @ p["wo"]


def attention_block_grid(pctx, p: dict, x: torch.Tensor, cfg,
                         pos_offset: int = 0) -> torch.Tensor:
    """x (B, S_loc, D_loc) -> (B, S_loc, D_loc) on one PE of the grid in
    the blocked (or skewed) layout: PE (i, j) holds positions
    ``[i S_loc, (i+1) S_loc)`` and its column's heads.  The projections
    round to x's dtype before the biases are added; K and V of every row
    are gathered (``all_gather_rows``), so each PE attends its query block
    against the whole sequence at query offset ``pos_offset + i S_loc``."""
    B, S_loc, _ = x.shape
    hd = cfg.head_dim
    i, _ = pctx.grid.my_coords()
    biases = [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else None
    q, k, v = fused_dense(pctx, x, [p["wq"], p["wk"], p["wv"]],
                          biases=biases)
    q = q.reshape(B, S_loc, -1, hd)
    k = k.reshape(B, S_loc, -1, hd)
    v = v.reshape(B, S_loc, -1, hd)
    if cfg.qk_norm:
        q = rms_norm_local(q, p["q_norm"])
        k = rms_norm_local(k, p["k_norm"])
    offset = pos_offset + i * S_loc
    pos = offset + torch.arange(S_loc, device=x.device)
    cos, sin = rope_tables(pos, hd, cfg.rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    k_full = pctx.grid.all_gather_rows(k, axis=1)     # (B, S, kvh_loc, hd)
    v_full = pctx.grid.all_gather_rows(v, axis=1)
    out = chunked_attention(q.transpose(1, 2), k_full.transpose(1, 2),
                            v_full.transpose(1, 2), q_offset=offset,
                            causal=cfg.causal, block_kv=cfg.attn_block_kv)
    out = out.transpose(1, 2).reshape(B, S_loc, -1)
    return dense(pctx, out, p["wo"], kind="crot")


def cross_kv(p: dict, enc: torch.Tensor, head_dim: int):
    """One decoder layer's cross-attention K and V, (B, S_enc, kvh, hd)
    each, projected from the encoder output enc (B, S_enc, D) with the
    layer's own weights, no bias (the K/V half of
    :func:`cross_attention_block`; the fixed-batch decode path caches
    it)."""
    B, S, _ = enc.shape
    return ((enc @ p["wk"]).reshape(B, S, -1, head_dim),
            (enc @ p["wv"]).reshape(B, S, -1, head_dim))


def cross_attention_block(p: dict, x: torch.Tensor, enc: torch.Tensor,
                          cfg) -> torch.Tensor:
    """Encoder-decoder cross attention (``repro.models.attention.
    cross_attention_block`` at q = r = 1): q from the decoder's x (B, S, D),
    K/V from the encoder output (:func:`cross_kv`), no bias, no RoPE
    (positions live in the encoder), no causal mask.  ``cfg`` is an
    ``AttnStatic``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, -1, hd)
    k, v = cross_kv(p, enc, hd)
    out = chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), q_offset=0, causal=False,
                            block_kv=cfg.attn_block_kv)
    return out.transpose(1, 2).reshape(B, S, -1) @ p["wo"]


class AttnPartial(NamedTuple):
    m: torch.Tensor      # (B, H, Sq)
    l: torch.Tensor      # (B, H, Sq)
    acc: torch.Tensor    # (B, H, Sq, D)


def attention_partial(q, k, v, *, kv_pos, q_pos,
                      scale: Optional[float] = None) -> AttnPartial:
    """Partial softmax stats of q (B, Hq, Sq, D) against k/v (B, Hkv, Skv, D).

    ``q_pos`` is (Sq,) or (B, Sq); ``kv_pos`` is (Skv,) or (B, Skv).  Key
    position labels past every query position are masked out; GQA maps
    query head h to kv head ``h // (Hq / Hkv)``."""
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kr = torch.repeat_interleave(k, group, dim=1).float()
    vr = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kr)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None]
    kp = kv_pos if kv_pos.ndim == 2 else kv_pos[None]
    mask = (qp[:, :, None] >= kp[:, None, :])[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return AttnPartial(m, l, acc)


def combine_partials(part, pctx=None) -> torch.Tensor:
    """Merge the softmax partials of every grid row with the log-sum-exp
    rule (``repro.models.attention.combine_partials`` over the rows, as
    ``repro/serve/decode.py:389,445`` call it): the global max by a row
    ``pmax``, each row's ``l`` and ``acc`` reweighted by ``exp(m - max)``
    and summed by one row ``psum`` (the two ride one message).  On one
    device (``pctx`` None or local) that is ``acc / max(l, 1e-30)``."""
    if pctx is not None and not pctx.local:
        grid = pctx.grid
        w = torch.exp(part.m - grid.pmax_rows(part.m))
        both = grid.psum_rows(torch.cat([part.acc * w[..., None],
                                         (part.l * w)[..., None]], dim=-1))
        return both[..., :-1] / torch.clamp(both[..., -1], min=1e-30)[
            ..., None]
    return part.acc / torch.clamp(part.l, min=1e-30)[..., None]
