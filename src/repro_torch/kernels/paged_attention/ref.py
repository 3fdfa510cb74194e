"""Plain PyTorch version of the fused paged-attention kernel.

The materialized-gather computation: take every table entry's page out of
the arena into a gathered ``(B, T * stride, kvh, hd)`` copy, label each
position, then run one masked softmax partial over the run
(:func:`repro_torch.models.attention.attention_partial`).  The CUDA kernel
must reproduce its row-merged output without ever materializing the copy;
this module is the oracle for that claim, and it is what
:func:`repro_torch.kernels.paged_attention.paged_attention` runs for
tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import counted
from repro_torch.models.attention import attention_partial

UNOWNED_POS = 2 ** 30     # past any q_pos: causally masked out


def gather_pages(kc, vc, table, *, stride, row, qrows):
    """Materialize this row's pages of every slot.  Returns (kg, vg, kv_pos)
    with kg/vg ``(B, T * stride, kvh, hd)`` and kv_pos ``(B, T * stride)``
    global position labels (unowned/unallocated entries pushed past any
    query).  Routing goes through :func:`ops.table_routing`, the rule the
    CUDA kernel applies to its own table entries."""
    from repro_torch.kernels.paged_attention.ops import table_routing
    B, T = table.shape
    kvh, hd = kc.shape[-2:]
    lidx, own = table_routing(table, row, qrows)
    lg = lidx.reshape(-1).long()
    kg = kc[lg].reshape(B, T * stride, kvh, hd)
    vg = vc[lg].reshape(B, T * stride, kvh, hd)
    pos_grid = (torch.arange(T, device=table.device)[:, None] * stride
                + torch.arange(stride, device=table.device)[None, :])
    kv_pos = torch.where(own.bool()[:, :, None], pos_grid[None],
                         UNOWNED_POS).reshape(B, T * stride)
    return kg, vg, kv_pos


def paged_attention_ref(q, kc, vc, table, q_pos, *, stride, row=0, qrows=1,
                        scale=None):
    """Gathered-copy paged attention partials ``(m, l, acc)``, fp32.

    q (B, Hq, L, hd); kc/vc (n_blocks_local, stride, kvh, hd);
    table (B, T) physical page ids (-1 unallocated); q_pos (B, L) global.
    Adds one to ``paged_attention_ref.launches`` per call."""
    paged_attention_ref.launches += 1
    kg, vg, kv_pos = gather_pages(kc, vc, table, stride=stride, row=row,
                                  qrows=qrows)
    return tuple(attention_partial(
        q, kg.transpose(1, 2), vg.transpose(1, 2), kv_pos=kv_pos,
        q_pos=q_pos, scale=scale))


counted(paged_attention_ref)


def merge_rows(partials):
    """LSE merge over per-row partials — the mirror of the SHMEM row merge
    over a q-row grid, for oracle checks."""
    ms = torch.stack([m for m, _, _ in partials])
    m_glob = torch.amax(ms, dim=0)
    w = torch.exp(ms - m_glob)
    l_glob = sum(l * w[i] for i, (_, l, _) in enumerate(partials))
    acc_glob = sum(a * w[i][..., None] for i, (_, _, a) in enumerate(partials))
    return acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]
