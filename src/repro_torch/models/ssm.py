"""Mamba2 (SSD) on one device (a 1x1 SHMEM grid): the serving steps and
the full-sequence training block.

The counterparts of ``repro.models.ssm``'s ``mamba_block``,
``mamba_chunk_step`` and ``mamba_decode_step`` at q = r = 1: the conv halo
exchange and the cross-row state relay are the identity (the state
entering row 0 is zero, so the relay's correction term is zero), every
head and channel is local, ``_slice_groups`` takes every group, and the
fused in-projection is five ``torch.matmul`` calls on the global
``[z | x | B | C | dt]`` weights.  The conv runs over the global channel
order ``[x | B | C]``.

On one PE of a ``q x r`` grid of PE processes (a ``pctx`` holding its
:class:`~repro_torch.core.pe_grid.PeGrid`) the two serving steps take the
grid form of ``repro/models/ssm.py:155-287``: the input is row-replicated
(the engine's ``repl_rows`` layout), so there is no halo and no relay;
column j owns heads ``[j H/r, (j+1) H/r)`` and the matching channels.  The
five in-projections are one ``fused_dense`` (gemv2d), the conv runs over
the local channel order ``[x_j | B_j | C_j]`` (:func:`_conv_param_slice`),
B and C are gathered over the columns and cut to the groups covering the
local heads (:func:`_slice_groups`), ``A``, ``dt_bias`` and ``D`` are
column-sliced, the gated norm adds its statistic over the columns, and
``wo`` is a gemv2d.  The SSD scan runs on the PE's ``H/r`` heads.

On one PE of the grid in the blocked layout (the training-style forward
and prefill) :func:`mamba_block` with a ``pctx`` is the sequence-sharded
block of ``repro/models/ssm.py:87-168``: grid row i holds positions
``[i S_loc, (i+1) S_loc)``.  The fused in-projection consumes the
residual layout (A-rotating under cannon_opt) and everything after it is
natural; the conv's halo is the last ``k-1`` pre-conv positions of row
``i-1``, put along ``row_shift_pairs(-1)`` and zeroed on row 0 (whose
source is row q-1's tail) by a product with a mask; each row scans its
block from a zero state, and the cross-row state relay adds what entered
it: every row's total decay and final state gathered over the rows, the
q-1 affine prefixes composed in row order on every row and this row's
picked by a one-hot product, and ``exp(cumsum dtA)_t C_t . state_in``
added.  Both keep the graph the same on every row, so the collectives'
backwards (the inverse put, the reduce-scatters) meet on every PE.  ``wo`` is
the C-rotating GEMM.

The serving steps, and the full-sequence block under ``torch.no_grad()``
(prefill, the forward-only loss; at 1x1 and on the grid alike), call the
SSD scan op, the hand-written kernels on the card (the JAX package's
``ssd_backend="pallas"``).  With autograd on, the block calls
:func:`ssd_scan_differentiable`, the port of the JAX package's jnp
backend (``repro.kernels.ssd_scan.ops``: ``_chunk_math_jnp``,
``_state_passing``, ``_apply_math_jnp``), which is what the JAX training
path runs (``ModelConfig.ssd_backend`` defaults to ``"jnp"``; the JAX
package never differentiates its Pallas scan).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan
from repro_torch.models.layers import (ParallelContext, col_slice, dense,
                                       fused_dense, rms_norm)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


_IN = ("wz", "wx", "wb", "wc", "wdt")


def _on_grid(pctx: Optional[ParallelContext]) -> bool:
    return pctx is not None and not pctx.local


def _in_proj(p: Dict, x: torch.Tensor,
             pctx: Optional[ParallelContext] = None):
    """The five in-projections: five products on one device, one fused
    gemv2d on a grid."""
    if _on_grid(pctx):
        return fused_dense(pctx, x, [p[name] for name in _IN])
    return tuple(x @ p[name] for name in _IN)


def _conv_param_slice(pctx: Optional[ParallelContext], w: torch.Tensor,
                      di: int, gn: int) -> torch.Tensor:
    """Conv weights or bias (..., di + 2 gn) cut to this column's local
    channel order ``[x_j | B_j | C_j]`` (the global order is ``[x | B |
    C]``, so one contiguous slice would mix segments); whole on one
    device."""
    if not _on_grid(pctx):
        return w
    r = pctx.r
    _, j = pctx.grid.my_coords()
    di_loc, gn_loc = di // r, gn // r
    return torch.cat([w[..., j * di_loc:(j + 1) * di_loc],
                      w[..., di + j * gn_loc:di + (j + 1) * gn_loc],
                      w[..., di + gn + j * gn_loc:di + gn + (j + 1) * gn_loc]],
                     dim=-1)


def _slice_groups(bc: torch.Tensor, G: int, r: int, j: int, axis: int
                  ) -> torch.Tensor:
    """The B/C groups covering column j's heads: G/r whole groups when
    G >= r, else the one group the r/G consecutive columns share."""
    if G >= r:
        if G % r:
            raise ValueError(f"{G} groups over {r} columns")
        gpc = G // r
        return bc.narrow(axis, j * gpc, gpc)
    if r % G:
        raise ValueError(f"{G} groups over {r} columns")
    return bc.narrow(axis, j // (r // G), 1)


def _local_bc(pctx: Optional[ParallelContext], Bc: torch.Tensor,
              Cc: torch.Tensor, G: int, N: int):
    """B and C (..., gn_loc) -> (..., G_loc, N) for this PE's heads: on a
    grid gathered over the columns, then cut to the covering groups."""
    lead = Bc.shape[:-1]
    if not _on_grid(pctx):
        return Bc.reshape(*lead, G, N), Cc.reshape(*lead, G, N)
    _, j = pctx.grid.my_coords()
    out = []
    for t in (Bc, Cc):
        full = pctx.grid.all_gather_cols(t, axis=-1).reshape(*lead, G, N)
        out.append(_slice_groups(full, G, pctx.r, j, axis=len(lead)))
    return tuple(out)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   halo: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, C), halo (B, k-1, C), w (k, C);
    products and sums in x's dtype, as the JAX code computes them."""
    k, S = w.shape[0], x.shape[1]
    xp = torch.cat([halo, x], dim=1)                       # (B, S+k-1, C)
    out = xp[:, 0:S] * w[0][None, None]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * w[i][None, None]
    if b is not None:
        out = out + b[None, None]
    return out.to(x.dtype)


def _gated_out(p: Dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               dtype, pctx: Optional[ParallelContext] = None,
               kind: str = "arot") -> torch.Tensor:
    """Skip (D), gate (silu z), grouped rms norm and out projection; on a
    grid over this PE's heads, the norm's statistic summed over the
    columns and ``wo`` a gemv2d (``repl_rows``) or the strategy's GEMM of
    ``kind`` (blocked); on one device ``col_slice`` and the norm's psum
    are the identity and ``dense`` is one product."""
    Dskip = col_slice(pctx, p["D"], xh.shape[-2]).float()
    y = y.float() + Dskip[:, None] * xh.float()
    y = y.reshape(z.shape) * F.silu(z.float())
    return dense(pctx, rms_norm(y.to(dtype), p["ssm_norm"], pctx=pctx),
                 p["wo"], kind=kind)


def _scan(x, dt, A, Bm, Cm, chunk: int):
    """The full-sequence scan from a zero state: the SSD scan op (the
    kernels on the card) under ``torch.no_grad()``, else the
    differentiable scan.  Returns (y, final state)."""
    if torch.is_grad_enabled():
        return ssd_scan_differentiable(x, dt, A, Bm, Cm, chunk=chunk)
    return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def _local_heads(pctx: Optional[ParallelContext], p: Dict, cfg):
    """(H_loc, A, dt_bias) of this PE's heads (every head on one
    device)."""
    h = cfg.ssm_heads // pctx.r if _on_grid(pctx) else cfg.ssm_heads
    return h, col_slice(pctx, p["A"], h), col_slice(pctx, p["dt_bias"], h)


def ssd_scan_differentiable(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, *, chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in differentiable torch, from a zero state.

    x (B, S, H, P), dt (B, S, H) fp32 (post-softplus), A (H,), Bm/Cm
    (B, S, G, N).  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32).  Per chunk of L = min(chunk, S) positions: the
    intra-chunk output ``(C B^T o decay) (dt x)`` rounded to x's dtype, the
    chunk's state contribution and the cumulative decay, all in fp32; the
    log-decays of masked (t < s) pairs are clamped to -60 before ``exp``,
    else they overflow and ``0 * inf`` poisons the gradient with NaN.  The
    states pass between chunks by the affine recurrence ``s' = d s + u``,
    here a sequential loop over chunks where JAX runs an associative scan:
    the same sums in another fp32 order.  Then ``y = y_intra + (C .
    state_in) cumexp``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of chunk {L}")
    nc, rep = S // L, H // G
    x32 = x.float().reshape(Bsz, nc, L, H, P)
    dt32 = dt.float().reshape(Bsz, nc, L, H)
    B32 = Bm.float().reshape(Bsz, nc, L, G, N)
    C32 = Cm.float().reshape(Bsz, nc, L, G, N)
    cum = torch.cumsum(dt32 * A.float(), dim=2)             # (B, nc, L, H)
    cumexp = torch.exp(cum)
    scores = torch.einsum("bctgn,bcsgn->bcgts", C32, B32)
    scores = scores.repeat_interleave(rep, dim=2)           # (B,nc,H,L,L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    cum_t = cum.transpose(2, 3)                              # (B, nc, H, L)
    ldecay = cum_t[..., :, None] - cum_t[..., None, :]
    decay = torch.exp(torch.where(causal, ldecay, -60.0))
    decay = torch.where(causal, decay, 0.0)
    w = scores * decay * dt32.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchts,bcshp->bcthp", w, x32).to(x.dtype)
    sdecay = torch.exp(cum[:, :, -1:, :] - cum) * dt32       # (B, nc, L, H)
    b_h = B32.repeat_interleave(rep, dim=3)                  # (B,nc,L,H,N)
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", sdecay, b_h, x32)
    chunk_decay = cumexp[:, :, -1, :][..., None, None]       # (B,nc,H,1,1)
    s_in = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    states_in = []
    for c in range(nc):
        states_in.append(s_in)
        s_in = chunk_decay[:, c] * s_in + states[:, c]
    states_in = torch.stack(states_in, dim=1)                # (B,nc,H,N,P)
    c_h = C32.repeat_interleave(rep, dim=3)
    y_inter = torch.einsum("bclhn,bchnp->bclhp", c_h, states_in) \
        * cumexp[..., None]
    y = (y_intra.float() + y_inter).to(x.dtype)
    return y.reshape(Bsz, S, H, P), s_in


def mamba_block(p: Dict, x: torch.Tensor, cfg,
                pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    """The full-sequence block (training, prefill): x (B, S, D) -> y
    (B, S, D).  Five in-projections, the causal conv (zero halo: the
    sequence starts here) with silu, softplus dt, the chunked scan at
    ``cfg.ssd_chunk`` (:func:`_scan`), the D skip, the gate and the grouped
    norm, the out projection.  With a blocked grid ``pctx``, x is this
    PE's (B, S_loc, D_loc) block and the block is the sequence-sharded one
    (:func:`_mamba_block_grid`)."""
    if pctx is not None and pctx.blocked:
        return _mamba_block_grid(pctx, p, x, cfg)
    Bsz, S = x.shape[:2]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    di, gn, kconv = H * P, G * N, cfg.conv_kernel

    z, xc, Bc, Cc, dt = _in_proj(p, x)
    xBC = torch.cat([xc, Bc, Cc], dim=-1)                  # (B, S, conv_ch)
    halo = torch.zeros_like(xBC[:, :kconv - 1])
    xBC = _conv1d_causal(xBC, p["conv_w"], p["conv_b"], halo)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xh = xBC[..., :di].reshape(Bsz, S, H, P)
    Bg = xBC[..., di:di + gn].reshape(Bsz, S, G, N)
    Cg = xBC[..., di + gn:].reshape(Bsz, S, G, N)
    dt = _softplus(dt.float() + p["dt_bias"])             # (B, S, H)
    y, _ = _scan(xh, dt, p["A"].float(), Bg, Cg, cfg.ssd_chunk)
    return _gated_out(p, y, xh, z, x.dtype)


def _mamba_block_grid(pctx: ParallelContext, p: Dict, x: torch.Tensor,
                      cfg) -> torch.Tensor:
    """The sequence-sharded block on one PE (module docstring): x (B,
    S_loc, D_loc) in the residual layout -> y in the residual layout."""
    grid = pctx.grid
    i, _ = grid.my_coords()
    Bsz, S_loc = x.shape[:2]
    P, G, N, kconv = (cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state,
                      cfg.conv_kernel)
    # the in-projection reads the residual layout (arot under cannon_opt);
    # every internal tensor is natural: column j owns head block j
    z, xc, Bc, Cc, dt = _in_proj(p, x, pctx)
    if pctx.act_layout == "skewed":
        pctx = pctx.with_(act_layout="blocked")
    H, A, dt_bias = _local_heads(pctx, p, cfg)
    di, gn = H * P, _bc_width(cfg, pctx)

    # ---- the causal conv with the halo of row i-1 --------------------------
    xBC = torch.cat([xc, Bc, Cc], dim=-1)                  # (B, S_loc, conv)
    tail = xBC[:, S_loc - (kconv - 1):]
    halo = grid.put(tail, grid.row_shift_pairs(-1))        # from row i-1
    # the sequence starts on row 0: its halo (row q-1's tail) masked by a
    # product, so the put's output stays in the graph on every row
    halo = halo * float(i != 0)
    xBC = _conv1d_causal(
        xBC, _conv_param_slice(pctx, p["conv_w"], cfg.d_inner, G * N),
        _conv_param_slice(pctx, p["conv_b"], cfg.d_inner, G * N), halo)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xh = xBC[..., :di].reshape(Bsz, S_loc, H, P)
    Bg, Cg = _local_bc(pctx, xBC[..., di:di + gn], xBC[..., di + gn:], G, N)
    dt = _softplus(dt.float() + dt_bias)                   # (B, S_loc, H)
    y0, contrib = _scan(xh, dt, A.float(), Bg, Cg, cfg.ssd_chunk)

    # ---- the cross-row state relay (affine prefix over the rows) -----------
    dtA = dt * A.float()[None, None]
    decay_tot = torch.exp(torch.sum(dtA, dim=1))[..., None, None]
    decays = grid.all_gather_rows(decay_tot[None], axis=0)  # (q,B,H,1,1)
    contribs = grid.all_gather_rows(contrib[None], axis=0)  # (q,B,H,N,P)
    # every row composes the same q-1 prefixes and selects its own by a
    # one-hot product (``repro/models/ssm.py:140-147``): the graph is the
    # same on every row, so their backward collectives meet
    state_in = torch.zeros_like(contrib)
    prefixes = [state_in]
    for s in range(grid.q - 1):
        state_in = decays[s] * state_in + contribs[s]
        prefixes.append(state_in)
    sel = torch.zeros(grid.q, dtype=torch.float32, device=x.device)
    sel[i] = 1.0
    state_in = torch.einsum("s,sbhnp->bhnp", sel, torch.stack(prefixes))
    cumexp = torch.exp(torch.cumsum(dtA, dim=1))           # (B, S_loc, H)
    c_h = Cg.float().repeat_interleave(H // Cg.shape[2], dim=2)
    y_corr = torch.einsum("bshn,bhnp->bshp", c_h, state_in) \
        * cumexp[..., None]
    y = y0.float() + y_corr
    return _gated_out(p, y, xh, z, x.dtype, pctx, kind="crot")


def _bc_width(cfg, pctx: Optional[ParallelContext]) -> int:
    """B's (and C's) channels on this PE: ``G N``, or ``G N / r`` on a
    grid."""
    gn = cfg.ssm_groups * cfg.ssm_state
    return gn // pctx.r if _on_grid(pctx) else gn


def mamba_chunk_step(p: Dict, x: torch.Tensor, state: Tuple, cfg,
                     n_valid: torch.Tensor,
                     pctx: Optional[ParallelContext] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """Multi-token state advance for chunked prefill.

    x (B, L, D); state = (conv_state (B, k-1, conv_ch) PRE-activation,
    ssm_state (B, H, N, P) fp32).  Slot b consumes chunk positions
    ``[0, n_valid[b])``: padding columns are state-neutral (their ``dt`` is
    zeroed, so the SSD recurrence is the identity there, and the new conv
    window gathers the last k-1 inputs *before* ``n_valid``), so one step
    serves every partial chunk.  The SSD scan runs with ``chunk = L``: the
    CUDA kernels on the card, their plain versions on the CPU.  With a
    grid ``pctx`` x is this PE's (B, L, D/r) block, and the state and the
    result are its columns' channels and heads (module docstring)."""
    conv_state, ssm_state = state
    B, L = x.shape[:2]
    P, G, N = cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    H, A, dt_bias = _local_heads(pctx, p, cfg)
    di, gn, kconv = H * P, _bc_width(cfg, pctx), cfg.conv_kernel

    z, xc, Bc, Cc, dt = _in_proj(p, x, pctx)
    xBC = torch.cat([xc, Bc, Cc], dim=-1)                  # (B, L, conv_ch)
    halo = conv_state.to(xBC.dtype)
    out = _conv1d_causal(
        xBC, _conv_param_slice(pctx, p["conv_w"], cfg.d_inner, G * N),
        _conv_param_slice(pctx, p["conv_b"], cfg.d_inner, G * N), halo)
    # new conv window: the last (k-1) PRE-activation inputs at positions
    # strictly before n_valid (n_valid = 0 leaves the state untouched)
    full = torch.cat([halo, xBC], dim=1)                   # (B, k-1+L, C)
    gidx = n_valid.long()[:, None] + torch.arange(kconv - 1,
                                                  device=x.device)[None]
    new_conv = torch.gather(
        full, 1, gidx[..., None].expand(B, kconv - 1, full.shape[-1]))
    xBC_a = F.silu(out.float()).to(x.dtype)
    xh = xBC_a[..., :di].reshape(B, L, H, P)
    Bg, Cg = _local_bc(pctx, xBC_a[..., di:di + gn], xBC_a[..., di + gn:],
                       G, N)

    dt = _softplus(dt.float() + dt_bias)                   # (B, L, H)
    valid = torch.arange(L, device=x.device)[None, :] < n_valid[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)            # identity step
    y, new_ssm = ssd_scan(xh, dt, A.float(), Bg, Cg,
                          init_state=ssm_state.float(), chunk=L)
    return _gated_out(p, y, xh, z, x.dtype, pctx), (new_conv, new_ssm)


def mamba_decode_step(p: Dict, x: torch.Tensor, state: Tuple, cfg,
                      pctx: Optional[ParallelContext] = None
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Single-token decode.  x (B, 1, D); state = (conv_state (B, k-1,
    conv_ch) PRE-activation, ssm_state (B, H, N, P) fp32).  The conv is an
    fp32 product over the window, as in the JAX decode step.  With a grid
    ``pctx``, this PE's columns (module docstring)."""
    conv_state, ssm_state = state
    B = x.shape[0]
    P, G, N = cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    H, A, dt_bias = _local_heads(pctx, p, cfg)
    di, gn = H * P, _bc_width(cfg, pctx)

    z, xc, Bc, Cc, dt = _in_proj(p, x, pctx)
    xBC = torch.cat([xc, Bc, Cc], dim=-1)[:, 0]            # (B, conv_ch)
    window = torch.cat([conv_state, xBC[:, None]], dim=1)  # (B, k, conv_ch)
    conv_w = _conv_param_slice(pctx, p["conv_w"], cfg.d_inner, G * N)
    conv_b = _conv_param_slice(pctx, p["conv_b"], cfg.d_inner, G * N)
    out = torch.einsum("bkc,kc->bc", window.float(), conv_w.float()) + conv_b
    xBC_t = F.silu(out).to(x.dtype)
    xh = xBC_t[:, :di].reshape(B, H, P)
    Bt, Ct = _local_bc(pctx, xBC_t[:, di:di + gn], xBC_t[:, di + gn:], G, N)
    dt_t = _softplus(dt[:, 0].float() + dt_bias)           # (B, H)
    y, new_ssm = ssd_decode_step(xh, dt_t, A.float(), Bt, Ct, ssm_state)
    return _gated_out(p, y, xh, z, x.dtype, pctx), (window[:, 1:], new_ssm)
