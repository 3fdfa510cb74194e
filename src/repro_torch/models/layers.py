"""Building blocks of the dense model on one device (a 1x1 SHMEM grid).

On one GPU the feature dim is never sharded, so the norms' column psums
are the identity and every projection is one ``torch.matmul`` (the JAX
package's ``dense``/``fused_dense`` gemv2d over the grid).  Numerics follow
``repro.models.layers``: statistics in fp32, results cast back to the
input dtype.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    d = scale.shape[-1]
    x32 = x.float()
    ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(ss / d + eps)
    return (x32 * inv * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    d = scale.shape[-1]
    x32 = x.float()
    mean = torch.sum(x32, dim=-1, keepdim=True) / d
    var = torch.sum(x32 * x32, dim=-1, keepdim=True) / d - mean * mean
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean) * inv * scale.float()
    return (y + bias.float()).to(x.dtype)


def rms_norm_local(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                   ) -> torch.Tensor:
    """Norm over the trailing dim (per-head qk-norm)."""
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _rope_freqs(head_dim: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` in fp32 on ``device``, made once:
    the exponent is formed in fp32, as the JAX package does, and the power
    is taken in fp64 on the host and rounded once, which gives the
    correctly rounded fp32 value (XLA's fp32 power agrees with it; an fp32
    ``torch.pow`` can be an ulp off, which grows with the position).  The
    one upload happens at the first call, outside any graph capture."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(torch.tensor(float(theta), dtype=torch.float64),
                      expo.double()).float()
    return freqs.to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(..., head_dim/2)`` in fp32 (frequencies from
    :func:`_rope_freqs`)."""
    freqs = _rope_freqs(head_dim, float(theta), positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., T, H, hd); cos/sin (..., T, hd/2) — rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations.
# ---------------------------------------------------------------------------

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# Norm and MLP blocks (``repro.models.transformer._norm`` / ``mlp_apply``).
# ---------------------------------------------------------------------------

def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = swiglu(x @ p["w_gate"], x @ p["w_up"])
    else:
        u = x @ p["w_up"]
        if cfg.mlp_bias:
            u = u + p["b_up"].to(u.dtype)
        h = gelu(u)
    y = h @ p["w_down"]
    if cfg.mlp_bias:
        y = y + p["b_down"].to(y.dtype)
    return y
