"""Mamba2 (SSD) serving steps on one device (a 1x1 SHMEM grid).

The counterparts of ``repro.models.ssm``'s ``mamba_chunk_step`` and
``mamba_decode_step`` at q = r = 1: the conv halo exchange and the
cross-row state relay are the identity, every head and channel is local,
``_slice_groups`` takes every group, and the fused in-projection is five
``torch.matmul`` calls on the global ``[z | x | B | C | dt]`` weights.  The
conv runs over the global channel order ``[x | B | C]``.  The full-sequence
``mamba_block`` (training) comes with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan
from repro_torch.models.layers import rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _in_proj(p: Dict, x: torch.Tensor):
    return tuple(x @ p[name] for name in ("wz", "wx", "wb", "wc", "wdt"))


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
               dtype) -> torch.Tensor:
    """Skip (D), gate (silu z), grouped rms norm and out projection."""
    y = y.float() + p["D"].float()[:, None] * xh.float()
    y = y.reshape(z.shape) * F.silu(z.float())
    return rms_norm(y.to(dtype), p["ssm_norm"]) @ p["wo"]


def mamba_chunk_step(p: Dict, x: torch.Tensor, state: Tuple, cfg,
                     n_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """Multi-token state advance for chunked prefill.

    x (B, L, D); state = (conv_state (B, k-1, conv_ch) PRE-activation,
    ssm_state (B, H, N, P) fp32).  Slot b consumes chunk positions
    ``[0, n_valid[b])``: padding columns are state-neutral (their ``dt`` is
    zeroed, so the SSD recurrence is the identity there, and the new conv
    window gathers the last k-1 inputs *before* ``n_valid``), so one step
    serves every partial chunk.  The SSD scan runs with ``chunk = L``: the
    CUDA kernels on the card, their plain versions on the CPU."""
    conv_state, ssm_state = state
    B, L = x.shape[:2]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    di, gn, kconv = H * P, G * N, cfg.conv_kernel

    z, xc, Bc, Cc, dt = _in_proj(p, x)
    xBC = torch.cat([xc, Bc, Cc], dim=-1)                  # (B, L, conv_ch)
    halo = conv_state.to(xBC.dtype)
    out = _conv1d_causal(xBC, p["conv_w"], p["conv_b"], halo)
    # new conv window: the last (k-1) PRE-activation inputs at positions
    # strictly before n_valid (n_valid = 0 leaves the state untouched)
    full = torch.cat([halo, xBC], dim=1)                   # (B, k-1+L, C)
    gidx = n_valid.long()[:, None] + torch.arange(kconv - 1,
                                                  device=x.device)[None]
    new_conv = torch.gather(
        full, 1, gidx[..., None].expand(B, kconv - 1, full.shape[-1]))
    xBC_a = F.silu(out.float()).to(x.dtype)
    xh = xBC_a[..., :di].reshape(B, L, H, P)
    Bg = xBC_a[..., di:di + gn].reshape(B, L, G, N)
    Cg = xBC_a[..., di + gn:].reshape(B, L, G, N)

    dt = _softplus(dt.float() + p["dt_bias"])              # (B, L, H)
    valid = torch.arange(L, device=x.device)[None, :] < n_valid[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)            # identity step
    y, new_ssm = ssd_scan(xh, dt, p["A"].float(), Bg, Cg,
                          init_state=ssm_state.float(), chunk=L)
    return _gated_out(p, y, xh, z, x.dtype), (new_conv, new_ssm)


def mamba_decode_step(p: Dict, x: torch.Tensor, state: Tuple, cfg
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Single-token decode.  x (B, 1, D); state = (conv_state (B, k-1,
    conv_ch) PRE-activation, ssm_state (B, H, N, P) fp32).  The conv is an
    fp32 product over the window, as in the JAX decode step."""
    conv_state, ssm_state = state
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    di, gn = H * P, G * N

    z, xc, Bc, Cc, dt = _in_proj(p, x)
    xBC = torch.cat([xc, Bc, Cc], dim=-1)[:, 0]            # (B, conv_ch)
    window = torch.cat([conv_state, xBC[:, None]], dim=1)  # (B, k, conv_ch)
    out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"]
    xBC_t = F.silu(out).to(x.dtype)
    xh = xBC_t[:, :di].reshape(B, H, P)
    Bt = xBC_t[:, di:di + gn].reshape(B, G, N)
    Ct = xBC_t[:, di + gn:].reshape(B, G, N)
    dt_t = _softplus(dt[:, 0].float() + p["dt_bias"])      # (B, H)
    y, new_ssm = ssd_decode_step(xh, dt_t, p["A"].float(), Bt, Ct, ssm_state)
    return _gated_out(p, y, xh, z, x.dtype), (window[:, 1:], new_ssm)
