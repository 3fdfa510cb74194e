"""Flash-decoding partials and their log-sum-exp merge.

``attention_partial`` scores q against one run of keys with per-position
labels and returns the unnormalised softmax partials ``(m, l, acc)``;
``combine_partials`` merges them.  On one device the KV cache is not
sharded, so the SHMEM row reductions are the identity and the merge
reduces to ``acc / max(l, 1e-30)``.

``NEG_INF`` stays finite: a row that has seen only masked keys keeps
``m = -1e30`` with ``exp(s - m) = 1``, which the merge then weighs to zero.
With ``-inf`` the same row would give NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


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


def combine_partials(part) -> torch.Tensor:
    """Normalise one device's partials: the LSE merge over a 1x1 grid."""
    return part.acc / torch.clamp(part.l, min=1e-30)[..., None]
