"""Distributed GEMM strategies on the emulated SHMEM PE grid.

The port of ``repro.core.cannon``: the paper's demonstration kernel and its
comparison points, written against :class:`~repro_torch.core.shmem.
ShmemGrid` stacks.  Every argument and result is a stack of per-PE blocks
of shape ``(q*r, ...)``; where the JAX function sees PE (i, j)'s block, this
one sees row ``i*r + j`` of the stack.

  * :func:`cannon_matmul` — the hybrid OpenCL+OpenSHMEM technique: operands
    staged once, then shifted between neighbour PEs (``put``).
  * :func:`cannon_matmul_crot` — A stationary, the accumulator rotates.
  * :func:`allgather_matmul` — the pure-OpenCL baseline: every PE fetches
    its full operand panels on every call.
  * :func:`summa_matmul` — broadcast-based 2D GEMM.
  * :func:`gemv2d` — small-M path against stationary 2D weights.

Given a :class:`~repro_torch.core.pe_grid.PeGrid` in place of the stack,
each function runs on one PE process's local blocks instead, as the JAX
function does inside ``shard_map``: a block ``(M_loc, K_loc)`` (or any
leading dims, flattened into M) against ``(K_loc, N_loc)``.  There they
are differentiable: every put and psum has its transpose as its backward
(:mod:`repro_torch.core.pe_grid`), and every local product's backward is
two more cannon_mm launches on transposed views (``dA = dC B^T``,
``dB = A^T dC``); the C-rotating accumulator is rounded to the input
dtype at every hop by a cast, which autograd follows.  The four
distributed GEMMs are the model's projections in the blocked layout
(:func:`repro_torch.models.layers.dense`), gemv2d the engine's.

Block convention (row-major grid, PE = (i, j) = (pe // r, pe % r)):
  A block at (i, j) = A[i-th M slice, j-th K slice]
  B block at (i, j) = B[i-th K slice, j-th N slice]
  C block at (i, j) = C[i-th M slice, j-th N slice]

Every local product of the four GEMMs is one launch of the hand-written
matmul kernel (:func:`_mm`; over all PEs at once on a stack, the plain
version on the CPU), accumulated in fp32 and cast back at the points the
JAX functions cast.  ``overlap``
orders the JAX program's shifts before the product that precedes them so
XLA can overlap the two; eager PyTorch on one stream runs ops in call
order either way, so here the argument is kept for the signature and
orders nothing.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.pe_grid import PeGrid
from repro_torch.core.shmem import ShmemGrid
from repro_torch.kernels.cannon_mm import blocked_matmul


def _mm(grid, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local block products in fp32: on a stack every PE's in one launch,
    (P, M, K) @ (P, K, N) -> (P, M, N), adding one PE's 2*M*K*N to
    ``grid.flops``; on a :class:`PeGrid` this PE's, a (..., K) flattened
    to (M, K) @ b (K, N) -> (..., N)."""
    if isinstance(grid, PeGrid):
        lead = a.shape[:-1]
        return blocked_matmul(a.reshape(-1, a.shape[-1]), b,
                              out_dtype=torch.float32).reshape(
                                  *lead, b.shape[-1])
    _, m, k = a.shape
    grid.flops += 2 * m * k * b.shape[-1]
    return blocked_matmul(a, b, out_dtype=torch.float32)


def _square(grid: ShmemGrid, what: str) -> None:
    if grid.q != grid.r:
        raise ValueError(f"{what} requires a square grid, got "
                         f"{grid.q}x{grid.r}")


def cannon_matmul(grid: ShmemGrid, a_blk: torch.Tensor, b_blk: torch.Tensor,
                  *, preskewed_b: bool = False, a_preskewed: bool = False,
                  overlap: bool = True,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Cannon's algorithm: C = A @ B on a q x q PE grid.

    a_blk (P, M_loc, K_loc), b_blk (P, K_loc, N_loc).  The initial skew
    aligns blocks so step s multiplies A[i, (i+j+s) % q] with
    B[(i+j+s) % q, j].  ``preskewed_b``: B is stored skewed
    (``block_2d(..., skew_b=True)``), so its skew put vanishes;
    ``a_preskewed``: A already lives in the skewed layout."""
    _square(grid, "Cannon")
    q = grid.q
    out_dtype = out_dtype or a_blk.dtype
    a = a_blk if a_preskewed else grid.put(a_blk, grid.skew_a_pairs())
    b = b_blk if preskewed_b else grid.put(b_blk, grid.skew_b_pairs())
    acc = None
    for s in range(q):
        prod = _mm(grid, a, b)
        acc = prod if acc is None else acc + prod
        if s < q - 1:
            a = grid.shift_cols(a, 1)       # A left by one
            b = grid.shift_rows(b, 1)       # B up by one
    return acc.to(out_dtype)


def cannon_matmul_crot(grid: ShmemGrid, a_blk: torch.Tensor,
                       b_blk: torch.Tensor, *, overlap: bool = True,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """C-rotating Cannon: A stationary, the accumulator rotates instead.

    a_blk natural, b_blk crot-stored (``block_2d(..., skew_b="crot")``: at
    (i, j) B[K_j, N_{(i+j+1)%q}]).  The travelling accumulator is held in
    the input dtype and rounded to it at every hop, as in the JAX function.
    Returns C at (i, j) = C[M_i, N_{(i+j)%q}] (the skewed layout)."""
    _square(grid, "crot")
    q = grid.q
    out_dtype = out_dtype or a_blk.dtype
    b = b_blk
    acc = torch.zeros(a_blk.shape[:-1] + (b_blk.shape[-1],),
                      dtype=a_blk.dtype, device=a_blk.device)
    for s in range(q):
        acc = (acc.float() + _mm(grid, a_blk, b)).to(a_blk.dtype)
        if s < q - 1:
            acc = grid.shift_cols(acc, 1)   # accumulator moves left
            b = grid.shift_rows(b, 1)       # N index +1 (from row i+1)
    return acc.to(out_dtype)


def allgather_matmul(grid: ShmemGrid, a_blk: torch.Tensor,
                     b_blk: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The pure-OpenCL baseline: all-gather the A panel across the grid row
    and the full B panel across the grid column, then one local product.
    Same output layout as :func:`cannon_matmul`, more bytes on the wire."""
    out_dtype = out_dtype or a_blk.dtype
    a_panel = grid.all_gather_cols(a_blk, axis=-1)     # (P, M_loc, K)
    b_panel = grid.all_gather_rows(b_blk, axis=0)      # (P, K, N_loc)
    return _mm(grid, a_panel, b_panel).to(out_dtype)


def summa_matmul(grid: ShmemGrid, a_blk: torch.Tensor, b_blk: torch.Tensor,
                 *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SUMMA: per K block s, broadcast along each row the A block held by
    col s and along each col the B block held by row s (mask + grouped
    sum), and accumulate."""
    _square(grid, "summa")
    out_dtype = out_dtype or a_blk.dtype
    if isinstance(grid, PeGrid):
        i, j = grid.my_coords()

        def held(blk, mine):
            # a product by the mask, as the JAX function has it: every PE
            # then records the same graph, and the psums' transposes run
            # on every PE of their groups
            return blk * float(mine)
    else:
        i, j = grid.my_coords(a_blk)

        def held(blk, mine):
            return blk * mine.to(blk.dtype)
    acc = None
    for s in range(grid.q):
        a_s = grid.psum_cols(held(a_blk, j == s))
        b_s = grid.psum_rows(held(b_blk, i == s))
        prod = _mm(grid, a_s, b_s)
        acc = prod if acc is None else acc + prod
    return acc.to(out_dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with an fp32 result, the JAX package's
    ``preferred_element_type=float32`` product: on the card a bf16 pair is
    multiplied as it is with fp32 output (``aten::mm.dtype``); on the CPU,
    which has no such product, the operands are upcast (the same math up to
    summation order), as are fp32 ones (a no-op)."""
    if x.is_cuda and x.dtype == w.dtype != torch.float32:
        lead = x.shape[:-1]
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def gemv2d(grid, x_vec: torch.Tensor, b_blk, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Small-M GEMM against stationary 2D-blocked weights (decode path).

    x_vec (P, M, K_loc): at (i, j) x[:, K_j], replicated over rows; b_blk
    (P, K_loc, N_loc) natural.  A grid transpose moves the feature shard
    onto rows, each PE multiplies, and the row sum contracts K.  Returns
    (P, M, N_loc): N over cols, replicated over rows.

    On a :class:`PeGrid` the same on one PE's blocks: x_vec (..., K_loc),
    b_blk (K_loc, N_loc), the local product in fp32 (:func:`matmul_f32`).
    ``b_blk`` may be a sequence of blocks of one input (a fused
    projection): their products are concatenated over N, so the put and
    the psum are paid once."""
    out_dtype = out_dtype or x_vec.dtype
    mm = matmul_f32 if isinstance(grid, PeGrid) \
        else functools.partial(_mm, grid)
    x_t = grid.put(x_vec, grid.transpose_pairs())
    if isinstance(b_blk, torch.Tensor):
        part = mm(x_t, b_blk)
    else:
        part = torch.cat([mm(x_t, b) for b in b_blk], dim=-1)
    return grid.psum_rows(part).to(out_dtype)


# ---------------------------------------------------------------------------
# Weight-block utilities (build/skew at parameter time).
# ---------------------------------------------------------------------------

def _block_index(i: int, j: int, q: int, skew) -> tuple:
    """(K-block, N-block) stored at PE (i, j) for a storage mode.

    skew=False : (i, j)            natural
    skew=True  : ((i+j)%q, j)      Cannon pre-skew (A-rotating GEMMs)
    skew="crot": (j, (i+j+1)%q)    C-rotating stationary-A storage
    """
    if skew == "crot":
        return j, (i + j + 1) % q
    if skew:
        return (i + j) % q, j
    return i, j


def block_2d(w: torch.Tensor, q: int, r: int, skew_b=False) -> torch.Tensor:
    """Split a global (K, N) matrix into the (q*r, K/q, N/r) stack of
    row-major PE blocks, in one of the three storage modes of
    :func:`_block_index`."""
    K, N = w.shape
    kb, nb = K // q, N // r
    if kb * q != K or nb * r != N:
        raise ValueError(f"{tuple(w.shape)} not divisible by {q}x{r}")
    blocks = []
    for i in range(q):
        for j in range(r):
            ki, nj = _block_index(i, j, q, skew_b)
            blocks.append(w[ki * kb:(ki + 1) * kb, nj * nb:(nj + 1) * nb])
    return torch.stack(blocks)


def unblock_2d(blocks: torch.Tensor, q: int, r: int,
               skew_b=False) -> torch.Tensor:
    """Inverse of :func:`block_2d`."""
    n, kb, nb = blocks.shape
    if n != q * r:
        raise ValueError(f"{n} blocks for a {q}x{r} grid")
    out = blocks.new_zeros((kb * q, nb * r))
    for i in range(q):
        for j in range(r):
            ki, nj = _block_index(i, j, q, skew_b)
            out[ki * kb:(ki + 1) * kb, nj * nb:(nj + 1) * nb] = \
                blocks[i * r + j]
    return out


def unskew_activation(grid: ShmemGrid, x: torch.Tensor) -> torch.Tensor:
    """Skewed residual layout -> natural blocked layout (one put)."""
    return grid.put(x, grid.unskew_a_pairs())


def skew_activation(grid: ShmemGrid, x: torch.Tensor) -> torch.Tensor:
    return grid.put(x, grid.skew_a_pairs())


def probe_gemms(grid, inputs) -> dict:
    """Every distributed GEMM once on this PE's blocks of the stacked fp32
    numpy ``inputs`` (``inputs[name][pe]``): ``a`` (n_pes, M, K/q) and the
    weight ``b`` (n_pes, K/q, N/r) natural, ``b_skew`` pre-skewed,
    ``b_crot`` in the C-rotating arrangement, and ``a16``/``b_crot16``,
    values that bf16 holds exactly, which run in bf16.  Returns the
    results as fp32 numpy: the grid's check against ``repro.core.cannon``
    under ``shard_map`` (the CPU tests).  A :class:`PeGrid` target."""
    def blk(name):
        t = torch.from_numpy(inputs[name][grid.pe].copy()).to(grid.device)
        return t.to(torch.bfloat16) if name.endswith("16") else t

    a, b, bs, bc = blk("a"), blk("b"), blk("b_skew"), blk("b_crot")
    grid.reserve(4 * max(a.numel(), b.numel(),
                         a.shape[0] * b.shape[1] * grid.q))
    out = {
        "cannon": cannon_matmul(grid, a, bs, preskewed_b=True),
        "cannon_skew_b": cannon_matmul(grid, a, b),
        "cannon_arot": cannon_matmul(grid, a, bs, preskewed_b=True,
                                     a_preskewed=True),
        "crot": cannon_matmul_crot(grid, a, bc),
        "crot_bf16": cannon_matmul_crot(grid, blk("a16"), blk("b_crot16")),
        "allgather": allgather_matmul(grid, a, b),
        "summa": summa_matmul(grid, a, b),
    }
    grid.barrier_all()
    return {k: v.float().cpu().numpy() for k, v in out.items()}
