"""Public paged-attention op: in-place page reads, routed by device.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), or the call
raises; a CPU tensor goes to the plain version (:mod:`.ref`).  There is no
backend string and no fallback.  Both return the same **LSE partials**
``(m, l, acc)`` over one grid row's pages, so the merge downstream
(``combine_partials``) cannot tell them apart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


class PagedPartial(NamedTuple):
    """Per-row softmax partials (attribute-compatible with ``AttnPartial``)."""
    m: torch.Tensor      # (B, Hq, L)
    l: torch.Tensor      # (B, Hq, L)
    acc: torch.Tensor    # (B, Hq, L, hd)


def table_routing(table: torch.Tensor, row: int, qrows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a ``(B, T)`` block table against one grid row.

    Physical page ``p`` lives on row ``p % qrows`` at local index
    ``p // qrows``.  Returns ``(lidx, own)`` int32: the clipped local index
    (unowned entries read page 0, which the mask discards) and the
    ownership flag.  On one GPU ``qrows == 1`` and every allocated page is
    local; the CUDA kernel applies the same rule to its table entries."""
    own = (table >= 0) & (table % qrows == row)
    lidx = torch.where(own, torch.div(table, qrows, rounding_mode="floor"),
                       0).to(torch.int32)
    return lidx, own.to(torch.int32)


def paged_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    table: torch.Tensor, q_pos: torch.Tensor, *, stride: int,
                    row: int = 0, qrows: int = 1,
                    scale: Optional[float] = None) -> PagedPartial:
    """Paged flash-decode partials of q against one row's arena pages.

    q (B, Hq, L, hd) — L = 1 for decode, L = chunk for chunked prefill;
    kc/vc (n_blocks_local, stride, kvh, hd); table (B, T) physical page ids
    (-1 = unallocated); q_pos (B, L) global query positions (padding
    columns produce partials the caller never reads)."""
    if q.device.type == "cpu":
        m, l, acc = paged_attention_ref(q, kc, vc, table, q_pos,
                                        stride=stride, row=row, qrows=qrows,
                                        scale=scale)
    elif q.is_cuda:
        m, l, acc = paged_attention_cuda(q, kc, vc, table, q_pos,
                                         stride=stride, row=row, qrows=qrows,
                                         scale=scale)
    else:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return PagedPartial(m, l, acc)
