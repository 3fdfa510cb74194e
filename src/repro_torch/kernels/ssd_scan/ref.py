"""Plain PyTorch versions of the Mamba2 SSD scan.

:func:`ssd_ref` is the exact sequential recurrence, the oracle
(``repro.kernels.ssd_scan.ref``):

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t (x) x_t,   y_t = C_t . s_t

:func:`ssd_chunk_ref` and :func:`ssd_apply_ref` are the plain versions of
the two passes: the same functions as the JAX package's ``_chunk_math_jnp``
and ``_apply_math_jnp``, with the full (H, L, L) decay tensor
materialized; :func:`_state_passing` is the JAX op's affine prefix over
chunks; :func:`ssd_scan_fused_ref`, the plain version of the fused kernel,
is the three in a row for a one-chunk sequence.  They are what
:func:`repro_torch.kernels.ssd_scan.ssd_scan` runs for tensors on the CPU,
and each kernel's plain version counts its calls.

Shapes: x (B, S, H, P), dt (B, S, H) [post-softplus, >= 0], A (H,)
[negative], B/C (B, S, G, N) with G groups broadcast over H, state
(B, H, N, P) fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import counted


def ssd_ref(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x32, dt32, A32 = x.float(), dt.float(), A.float()
    b_h = Bm.float().repeat_interleave(rep, dim=2)      # (B, S, H, N)
    c_h = Cm.float().repeat_interleave(rep, dim=2)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                        device=x.device) if init_state is None \
        else init_state.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt32[:, t] * A32)                 # (B, H)
        state = (dA[:, :, None, None] * state
                 + (dt32[:, t, :, None] * b_h[:, t])[..., None]
                 * x32[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", c_h[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunk_ref(x, dt, A, Bm, Cm, *, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 over all chunks: x (B, S, H, P) -> (y_intra (B, nc, L, H, P)
    in x's dtype, states (B, nc, H, N, P) fp32, cumexp (B, nc, L, H) fp32).
    Adds one to ``ssd_chunk_ref.launches`` per call."""
    ssd_chunk_ref.launches += 1
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = chunk
    nc = S // L
    rep = H // G
    x32 = x.reshape(B, nc, L, H, P).float()
    dt32 = dt.reshape(B, nc, L, H).float()
    B32 = Bm.reshape(B, nc, L, G, N).float()
    C32 = Cm.reshape(B, nc, L, G, N).float()
    cum = torch.cumsum(dt32 * A.float(), dim=2)            # (B, nc, L, H)
    cumexp = torch.exp(cum)
    scores = torch.einsum("bctgn,bcsgn->bcgts", C32, B32)
    scores = scores.repeat_interleave(rep, dim=2)          # (B, nc, H, L, L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    cum_h = cum.transpose(2, 3)                            # (B, nc, H, L)
    ldecay = cum_h[..., :, None] - cum_h[..., None, :]
    # clamp BEFORE exp: masked (t < s) entries are positive and would
    # overflow
    decay = torch.exp(torch.where(causal, ldecay, -60.0))
    decay = torch.where(causal, decay, 0.0)
    w = scores * decay * dt32.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchts,bcshp->bcthp", w, x32)
    sdecay = torch.exp(cum[:, :, -1:, :] - cum) * dt32     # (B, nc, L, H)
    b_h = B32.repeat_interleave(rep, dim=3)                # (B, nc, L, H, N)
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", sdecay, b_h, x32)
    # contiguous, as the kernel writes them (einsum may return views)
    return (y_intra.to(x.dtype).contiguous(), states.contiguous(),
            cumexp.contiguous())


counted(ssd_chunk_ref)


def ssd_apply_ref(y_intra, Cm, cumexp, states_in) -> torch.Tensor:
    """Pass 2: ``y = y_intra + (C_t . states_in[c]) * cumexp``, fp32 math,
    out in y_intra's dtype.  Cm (B, nc, L, G, N).  Adds one to
    ``ssd_apply_ref.launches`` per call."""
    ssd_apply_ref.launches += 1
    rep = y_intra.shape[3] // Cm.shape[3]
    c_h = Cm.float().repeat_interleave(rep, dim=3)         # (B, nc, L, H, N)
    y_inter = torch.einsum("bclhn,bchnp->bclhp", c_h, states_in) \
        * cumexp[..., None]
    return (y_intra.float() + y_inter).to(y_intra.dtype).contiguous()


counted(ssd_apply_ref)


def _state_passing(states: torch.Tensor, chunk_decay: torch.Tensor,
                   init_state: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine prefix over chunks: the state entering chunk c is the
    product of the earlier chunks' decays times ``init`` plus their
    decayed contributions.

    states (B, nc, H, N, P) fp32, chunk_decay (B, nc, H) fp32, init_state
    (B, H, N, P).  Returns (states_in (B, nc, H, N, P), final (B, H, N, P)).
    As in the JAX op, the inclusive (decay product, contribution) pair is
    formed first and applied to ``init`` once, so at nc = 1 this is exactly
    ``states_in = init`` and ``final = decay * init + state``."""
    d = chunk_decay[..., None, None]                      # (B, nc, H, 1, 1)
    dacc = torch.cumprod(d, dim=1)
    acc, sacc = None, []
    for c in range(states.shape[1]):
        acc = states[:, c] if acc is None else d[:, c] * acc + states[:, c]
        sacc.append(acc)
    init = init_state[:, None].float()
    s_after = dacc * init + torch.stack(sacc, dim=1)      # state AFTER chunk c
    states_in = torch.cat([init, s_after[:, :-1]], dim=1)
    return states_in, s_after[:, -1]


def ssd_scan_fused_ref(x, dt, A, Bm, Cm, init_state, *, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of a one-chunk sequence (S == ``chunk``): pass 1, the state
    passing from ``init_state`` (B, H, N, P) fp32, pass 2.  Returns (y
    (B, S, H, P) in x's dtype, final (B, H, N, P) fp32).  Adds one to
    ``ssd_scan_fused_ref.launches`` per call."""
    ssd_scan_fused_ref.launches += 1
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S != chunk:
        raise ValueError(f"ssd_scan_fused_ref: one chunk only, got S={S} "
                         f"chunk={chunk}")
    y_intra, states, cumexp = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=chunk)
    states_in, final = _state_passing(states, cumexp[:, :, -1, :],
                                      init_state)
    y = ssd_apply_ref(y_intra, Cm.reshape(B, 1, S, G, N), cumexp, states_in)
    return y.reshape(B, S, H, P), final


counted(ssd_scan_fused_ref)
