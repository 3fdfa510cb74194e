"""AdamW with optional 8-bit moments, on one device (``repro.optim.adamw``).

The same update as the JAX package, leaf by leaf: the global-norm clip,
the bias corrections, the decoupled weight decay on the decay mask, the
arithmetic in fp32 and the new parameter rounded once to its dtype.  With
``state_bits=8`` each moment is block-quantized over its flattened leaf in
blocks of 128: int8 codes and an fp32 scale ``max|x| / 127 + 1e-12`` per
block (the JAX package quantizes each local shard: on one device the shard
is the leaf, and on a grid of PE processes the step hands this module each
PE's local blocks, so each block is quantized alone, as in JAX's
``shard_map`` body).

The port updates in place where JAX returns new arrays: the parameters,
the fp32 moments and the int8 codes and scales are written where they
lie.  The update runs over slices of each leaf's flattened elements (at
most ``max_slice``, a multiple of 256, and never across the parts of a
:class:`~repro_torch.tree.Pieces` gradient whose sizes are multiples of
256), so its fp32 temporaries are a few slices and not a few leaves: one
qwen3-moe expert leaf holds 1.61 G elements a layer, and four fp32
temporaries of it would take 26 GB.  Every operation is elementwise or
block-local with blocks that a slice never splits, so the slices give the
same bits as one pass over the leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import Pieces, leaves, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 or 8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


QBLOCK = 128
# elements an update slice holds at most (a multiple of 256, the larger
# of the moment and compression blocks)
MAX_SLICE = 1 << 25


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten, pad with zeros to a multiple of 128, and quantize each
    block: (codes (nb, 128) int8, scales (nb, 1) fp32)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % QBLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


class MomentState(NamedTuple):
    dense: Optional[torch.Tensor]          # fp32 (state_bits=32)
    q: Optional[torch.Tensor]              # int8  (state_bits=8)
    scale: Optional[torch.Tensor]


def _init_moment(p: torch.Tensor, bits: int) -> MomentState:
    if bits == 8:
        nb = -(-p.numel() // QBLOCK)
        return MomentState(
            None, torch.zeros((nb, QBLOCK), dtype=torch.int8,
                              device=p.device),
            torch.full((nb, 1), 1e-12, dtype=torch.float32,
                       device=p.device))
    if bits != 32:
        raise ValueError(f"state_bits must be 32 or 8, got {bits}")
    return MomentState(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), None, None)


def is_moment(node) -> bool:
    return isinstance(node, MomentState)


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """{step: 0 (int32), m, v: a MomentState per leaf}, on the leaves'
    device."""
    flat = leaves(params)
    dev = flat[0].device
    return dict(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=unflatten(params, [_init_moment(p, cfg.state_bits)
                             for p in flat]),
        v=unflatten(params, [_init_moment(p, cfg.state_bits)
                             for p in flat]))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio * lr`` at ``decay_steps``; fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def pieces_of(g) -> List[torch.Tensor]:
    return list(g) if isinstance(g, Pieces) else [g]


def global_norm(grads) -> torch.Tensor:
    """L2 norm over every leaf (and every part of a Pieces leaf), fp32."""
    sq = sum(torch.sum(torch.square(t.float()))
             for g in leaves(grads) for t in pieces_of(g))
    return torch.sqrt(sq)


def segments(g, block: int) -> List[Tuple[int, torch.Tensor]]:
    """The gradient of one leaf as (flat start, flat part) pairs: a Pieces
    leaf part by part when every part's size is a multiple of ``block``,
    else joined into one."""
    parts = pieces_of(g)
    if len(parts) > 1 and any(t.numel() % block for t in parts):
        parts = [torch.cat([t.reshape(-1) for t in parts])]
    out, start = [], 0
    for t in parts:
        out.append((start, t.reshape(-1)))
        start += t.numel()
    return out


def slices(g, block: int = 256, max_slice: int = MAX_SLICE
           ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(lo, hi, gradient) over a leaf's flattened elements: each segment
    (:func:`segments`) in slices of ``max_slice`` rounded down to a
    multiple of ``block``."""
    size = max(block, max_slice // block * block)
    for start, flat in segments(g, block):
        for a in range(0, flat.numel(), size):
            b = min(a + size, flat.numel())
            yield start + a, start + b, flat[a:b]


def _read(m: MomentState, lo: int, hi: int) -> torch.Tensor:
    if m.dense is not None:
        return m.dense.view(-1)[lo:hi]
    b0, b1 = lo // QBLOCK, -(-hi // QBLOCK)
    return (m.q[b0:b1].float() * m.scale[b0:b1]).reshape(-1)[:hi - lo]


def _write(m: MomentState, lo: int, hi: int, val: torch.Tensor) -> None:
    if m.dense is not None:
        m.dense.view(-1)[lo:hi] = val
        return
    q, s = _quantize(val)
    b0 = lo // QBLOCK
    m.q[b0:b0 + q.shape[0]] = q
    m.scale[b0:b0 + q.shape[0]] = s


def apply_updates(params, grads, state: Dict[str, Any], cfg: AdamWConfig,
                  decay_mask=None, grad_norm: Optional[torch.Tensor] = None,
                  max_slice: int = MAX_SLICE):
    """One AdamW step, in place.  ``grads`` has the parameters' structure,
    each leaf a tensor or a :class:`Pieces` of its parts along the first
    dim; ``decay_mask`` a bool per leaf (all True when None);
    ``grad_norm`` the global norm when the caller has it.  Returns
    (params, state, {grad_norm, lr}), the same objects updated."""
    step = state["step"] + 1
    gnorm = grad_norm if grad_norm is not None else global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0) if cfg.grad_clip > 0 else 1.0
    lr = lr_schedule(cfg, step)
    step32 = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=step.device), step32)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=step.device), step32)

    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_m = leaves(state["m"], is_moment)
    flat_v = leaves(state["v"], is_moment)
    flat_mask = leaves(decay_mask) if decay_mask is not None \
        else [True] * len(flat_p)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_mask):
        raise ValueError("params, grads, moments and mask differ in leaves")
    for p, g, m, v, dm in zip(flat_p, flat_g, flat_m, flat_v, flat_mask):
        pf = p.view(-1)
        for lo, hi, gs in slices(g, max_slice=max_slice):
            g32 = gs.float() * clip
            mval = _read(m, lo, hi) * cfg.b1 + (1 - cfg.b1) * g32
            vval = _read(v, lo, hi) * cfg.b2 + (1 - cfg.b2) * g32 * g32
            upd = (mval / b1c) / (torch.sqrt(vval / b2c) + cfg.eps)
            p32 = pf[lo:hi].float()
            if dm and cfg.weight_decay > 0:
                upd = upd + cfg.weight_decay * p32
            pf[lo:hi] = (p32 - lr * upd).to(p.dtype)
            _write(m, lo, hi, mval)
            _write(v, lo, hi, vval)
    state = dict(state, step=step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
