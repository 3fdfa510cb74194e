"""Building blocks of the dense model: on one device, and on one PE of a
``q x r`` grid of PE processes.

On one GPU (a 1x1 grid, ``pctx`` None or local) the feature dim is never
sharded, so the norms' column psums are the identity and every projection
is one ``torch.matmul`` (the JAX package's ``dense``/``fused_dense``
gemv2d over the grid).  On a grid of PE processes
(:class:`~repro_torch.core.pe_grid.PeGrid`) these are
``repro.models.layers``' functions on one PE's blocks, in one of the JAX
package's activation layouts (``ParallelContext.act_layout``):

  * ``repl_rows`` (the serving engine): features over grid columns,
    replicated over rows; :func:`dense` and :func:`fused_dense` are
    ``gemv2d`` (a transpose put, the local product in fp32, a row psum; a
    fused projection pays the put and the psum once) on natural blocks;
  * ``blocked`` (the training-style forward, prefill and the batched
    decode): tokens over grid rows, features over columns; every
    projection is the distributed GEMM of ``tp_strategy`` (cannon,
    cannon_opt, allgather or summa, :mod:`repro_torch.core.cannon`) on
    weights stored as that strategy wants them (pre-skewed for Cannon);
  * ``skewed`` (cannon_opt's residual stream): ``blocked`` with PE (i, j)
    holding feature block ``(i + j) % q``; the A-rotating GEMMs consume
    it, the C-rotating ones (``kind="crot"``) produce it.

:func:`col_slice` cuts this PE's column block of a replicated bias or
scale (block ``(i + j) % q`` under ``skewed``), :func:`row_slice_tokens`
its sequence block, and the norms add their statistics over the grid
columns.  Numerics follow ``repro.models.layers``: statistics in fp32,
results cast back to the input dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.cannon import (allgather_matmul, cannon_matmul,
                                     cannon_matmul_crot, gemv2d,
                                     summa_matmul)

TP_STRATEGIES = ("cannon", "cannon_opt", "allgather", "summa")


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The grid a layer runs on (``repro.models.layers.ParallelContext``).
    ``grid`` None is one device.  The default is the serving engine's:
    ``act_layout`` ``repl_rows``, weights stored unskewed, every
    projection a gemv2d; the blocked forward sets ``tp_strategy``,
    ``preskewed`` and ``act_layout`` as
    :func:`repro_torch.train.step.make_pctx` makes them."""

    grid: Optional[object] = None          # a PeGrid, or None (1x1)
    act_layout: str = "repl_rows"          # repl_rows | blocked | skewed
    compute_dtype: torch.dtype = torch.float32
    tp_strategy: str = "cannon"            # cannon | cannon_opt | allgather
    #                                        | summa
    preskewed: bool = False                # weights stored Cannon-pre-skewed

    def with_(self, **kw) -> "ParallelContext":
        return dataclasses.replace(self, **kw)

    @property
    def blocked(self) -> bool:
        """Tokens over the grid rows (the ``blocked`` and ``skewed``
        layouts), on a grid of several PEs."""
        return not self.local and self.act_layout != "repl_rows"

    @property
    def local(self) -> bool:
        return self.grid is None or self.grid.local

    @property
    def q(self) -> int:
        return 1 if self.grid is None else self.grid.q

    @property
    def r(self) -> int:
        return 1 if self.grid is None else self.grid.r


def col_slice(pctx: Optional[ParallelContext], vec: torch.Tensor,
              n_loc: Optional[int] = None,
              layout: Optional[str] = None) -> torch.Tensor:
    """This PE's column block of a replicated feature vector (..., N).
    ``layout`` is the layout of the tensor the slice combines with (the
    residual stream's, ``pctx.act_layout``, by default): under ``skewed``
    PE (i, j) holds feature block ``(i + j) % q``, else block j."""
    if pctx is None or pctx.local:
        return vec
    n_loc = n_loc or vec.shape[-1] // pctx.r
    i, j = pctx.grid.my_coords()
    idx = (i + j) % pctx.q if (layout or pctx.act_layout) == "skewed" \
        else j
    return vec[..., idx * n_loc:(idx + 1) * n_loc]


def row_slice_tokens(pctx: ParallelContext, x: torch.Tensor, axis: int = 1
                     ) -> torch.Tensor:
    """This PE's sequence block (S/q positions, grid row i) of an array
    whose ``axis`` holds the whole sequence."""
    s_loc = x.shape[axis] // pctx.q
    i, _ = pctx.grid.my_coords()
    return x.narrow(axis, i * s_loc, s_loc)


def _blocked_gemm(pctx: ParallelContext, x: torch.Tensor, w: torch.Tensor,
                  out_dtype, kind: str) -> torch.Tensor:
    """The distributed GEMM of ``pctx.tp_strategy`` on this PE's blocks
    (``repro/models/layers.py:81-99``).  ``kind`` matters under
    cannon_opt only: ``arot`` consumes the skewed residual and outputs
    natural blocks, ``crot`` consumes natural blocks and outputs skewed
    ones, ``std`` is classic Cannon with the A skew (natural in and out)."""
    grid, strategy = pctx.grid, pctx.tp_strategy
    if strategy == "cannon":
        return cannon_matmul(grid, x, w, preskewed_b=pctx.preskewed,
                             out_dtype=out_dtype)
    if strategy == "cannon_opt":
        if kind == "crot":
            return cannon_matmul_crot(grid, x, w, out_dtype=out_dtype)
        if kind not in ("arot", "std"):
            raise ValueError(f"kind must be arot, crot or std, got {kind!r}")
        return cannon_matmul(grid, x, w, preskewed_b=True,
                             a_preskewed=kind == "arot", out_dtype=out_dtype)
    if strategy == "allgather":
        return allgather_matmul(grid, x, w, out_dtype=out_dtype)
    if strategy == "summa":
        return summa_matmul(grid, x, w, out_dtype=out_dtype)
    raise ValueError(f"tp_strategy must be one of {TP_STRATEGIES}, got "
                     f"{strategy!r}")


def dense(pctx: Optional[ParallelContext], x: torch.Tensor, w: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          out_dtype: Optional[torch.dtype] = None,
          kind: str = "arot") -> torch.Tensor:
    """x (..., K_loc) @ W -> (..., N_loc): ``x @ w`` on one device; on a
    grid in the ``repl_rows`` layout ``gemv2d`` on this PE's natural block
    ``w`` (K/q, N/r), in the blocked layouts the strategy's distributed
    GEMM (``kind``: see :func:`_blocked_gemm`); the result in ``out_dtype``
    (x's by default), then this PE's slice of ``bias`` (natural: a crot
    output is skewed and takes none, as in the JAX package)."""
    if pctx is None or pctx.local:
        y = x @ w
    elif pctx.blocked:
        if bias is not None and kind == "crot" \
                and pctx.tp_strategy == "cannon_opt":
            raise ValueError("crot outputs are skewed; fold the bias "
                             "upstream")
        y = _blocked_gemm(pctx, x, w, out_dtype or x.dtype, kind)
    else:
        y = gemv2d(pctx.grid, x, w, out_dtype=out_dtype or x.dtype)
    if bias is not None:
        y = y + col_slice(pctx, bias, y.shape[-1], layout="blocked").to(
            y.dtype)
    return y


def fused_dense(pctx: Optional[ParallelContext], x: torch.Tensor,
                ws: Sequence[torch.Tensor],
                biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
                kind: str = "arot") -> Tuple[torch.Tensor, ...]:
    """Several projections of the same input (QKV, gate and up).  On one
    device one ``x @ w`` each, as the 1x1 path always did; on a grid in
    ``repl_rows`` one ``gemv2d`` over all the blocks, so one transpose put
    and one row psum (the JAX package concatenates the weights; here the
    fp32 partial products are concatenated, which is the same column for
    column); in the blocked layouts the blocks concatenated along N and
    one distributed GEMM, as the JAX package does, so the A operand
    travels once."""
    if pctx is None or pctx.local:
        ys = [x @ w for w in ws]
    elif pctx.blocked:
        y = _blocked_gemm(pctx, x, torch.cat(list(ws), dim=-1), x.dtype,
                          kind)
        ys = list(torch.split(y, [w.shape[-1] for w in ws], dim=-1))
    else:
        y = gemv2d(pctx.grid, x, ws, out_dtype=x.dtype)
        ys = list(torch.split(y, [w.shape[-1] for w in ws], dim=-1))
    if biases is not None:
        ys = [y if b is None else y + col_slice(
            pctx, b, y.shape[-1], layout="blocked").to(y.dtype)
            for y, b in zip(ys, biases)]
    return tuple(ys)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    d = scale.shape[-1]
    x32 = x.float()
    ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
    if pctx is not None and not pctx.local:
        ss = pctx.grid.psum_cols(ss)
    inv = torch.rsqrt(ss / d + eps)
    return (x32 * inv * col_slice(pctx, scale).float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, pctx: Optional[ParallelContext] = None
               ) -> torch.Tensor:
    """On a grid the two statistics ride one column psum."""
    d = scale.shape[-1]
    x32 = x.float()
    s1 = torch.sum(x32, dim=-1, keepdim=True)
    s2 = torch.sum(x32 * x32, dim=-1, keepdim=True)
    if pctx is not None and not pctx.local:
        s1, s2 = pctx.grid.psum_cols(torch.cat([s1, s2], dim=-1)).split(1, -1)
    mean = s1 / d
    var = s2 / d - mean * mean
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean) * inv * col_slice(pctx, scale).float()
    return (y + col_slice(pctx, bias).float()).to(x.dtype)


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

def apply_norm(cfg, p: dict, x: torch.Tensor,
               pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], pctx=pctx)
    return rms_norm(x, p["scale"], pctx=pctx)


def mlp_apply(cfg, p: dict, x: torch.Tensor,
              pctx: Optional[ParallelContext] = None) -> torch.Tensor:
    if pctx is not None and not pctx.local:
        # the grid form (repro.models.transformer.mlp_apply): gate and up
        # in one fused projection, the down projection in another (the
        # C-rotating GEMM under cannon_opt)
        if cfg.act == "swiglu":
            g, u = fused_dense(pctx, x, [p["w_gate"], p["w_up"]])
            h = swiglu(g, u)
        else:
            (u,) = fused_dense(pctx, x, [p["w_up"]], biases=[
                p["b_up"] if cfg.mlp_bias else None])
            h = gelu(u)
        return dense(pctx, h, p["w_down"],
                     bias=p["b_down"] if cfg.mlp_bias else None,
                     kind="crot")
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
