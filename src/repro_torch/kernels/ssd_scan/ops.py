"""Public SSD scan op: the chunked algorithm, routed by device.

A CUDA tensor goes to the hand-written kernels (:mod:`.kernel`) on the
route :func:`.kernel.plan` names: a sequence of one chunk with bf16 x (the
engine's every call) to the one fused launch, anything else to the chunk
pass, the state passing and the apply pass.  A CPU tensor goes to the
plain versions of the same route (:mod:`.ref`).  A meta tensor (the dry
run, ``launch/dryrun.py``) takes the meta route: each launch an empty
meta tensor of its kernel's outputs, so the dry run's memory account sees
what the kernels allocate (their operations are not counted).  There is no
backend string and no fallback; any other device raises.  The cross-chunk state
passing is an affine recurrence ``s' = d * s + u`` over tiny (H, N, P)
tensors, a plain torch op, as is the one-token :func:`ssd_decode_step`
(jnp code in the JAX package, not a Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import (plan, route, ssd_apply_cuda,
                                                 ssd_chunk_cuda,
                                                 ssd_scan_fused_cuda)
from repro_torch.kernels.ssd_scan.ref import (_state_passing, ssd_apply_ref,
                                              ssd_chunk_ref,
                                              ssd_scan_fused_ref)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm
    (B, S, G, N), init_state (B, H, N, P) fp32 (zeros when None).
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P) fp32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of chunk {L}")
    nc = S // L
    if init_state is None:
        init_state = torch.zeros((B, H, N, P), dtype=torch.float32,
                                 device=x.device)
    if x.device.type == "cpu":
        rt = route(x.dtype, N, nc)[0]
        fused_fn, chunk_fn, apply_fn = (ssd_scan_fused_ref, ssd_chunk_ref,
                                        ssd_apply_ref)
    elif x.is_cuda:
        rt = plan(x, Bm, Cm, chunk=L).route
        fused_fn, chunk_fn, apply_fn = (ssd_scan_fused_cuda, ssd_chunk_cuda,
                                        ssd_apply_cuda)
    elif x.is_meta:
        rt = route(x.dtype, N, nc)[0]
        fused_fn, chunk_fn, apply_fn = _fused_meta, _chunk_meta, _apply_meta
    else:
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if rt == "fused":
        return fused_fn(x, dt, A, Bm, Cm, init_state.float(), chunk=L)
    y_intra, states, cumexp = chunk_fn(x, dt, A, Bm, Cm, chunk=L)
    states_in, final = _state_passing(states, cumexp[:, :, -1, :],
                                      init_state)
    y = apply_fn(y_intra, Cm.reshape(B, nc, L, G, N), cumexp, states_in)
    return y.reshape(B, S, H, P), final


def _fused_meta(x, dt, A, Bm, Cm, init_state, *, chunk):
    B, _, H, P = x.shape
    return torch.empty_like(x), x.new_empty((B, H, Bm.shape[-1], P),
                                            dtype=torch.float32)


def _chunk_meta(x, dt, A, Bm, Cm, *, chunk):
    B, S, H, P = x.shape
    nc, N = S // chunk, Bm.shape[-1]
    return (x.new_empty((B, nc, chunk, H, P)),
            x.new_empty((B, nc, H, N, P), dtype=torch.float32),
            x.new_empty((B, nc, chunk, H), dtype=torch.float32))


def _apply_meta(y_intra, Cm, cumexp, states_in):
    return torch.empty_like(y_intra)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence (serve decode).  x (B, H, P), dt (B, H),
    Bm/Cm (B, G, N), state (B, H, N, P) -> (y (B, H, P) in x's dtype, new
    state fp32)."""
    rep = x.shape[1] // Bm.shape[1]
    dt32 = dt.float()
    dA = torch.exp(dt32 * A.float())                        # (B, H)
    b_h = Bm.float().repeat_interleave(rep, dim=1)          # (B, H, N)
    c_h = Cm.float().repeat_interleave(rep, dim=1)
    state = (dA[:, :, None, None] * state
             + (dt32[:, :, None] * b_h)[..., None]
             * x.float()[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", c_h, state)
    return y.to(x.dtype), state
