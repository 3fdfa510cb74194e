"""OpenSHMEM-style PGAS layer, emulated over a leading PE dimension.

The JAX package runs one program per device inside ``shard_map`` and lowers
``put`` to ``lax.ppermute``.  On one card there is one device, so here the
``q x r`` PE grid is a leading dimension: every method takes and returns a
*stack* of shape ``(q*r, ...)`` whose row ``pe`` is the local block of PE
``pe`` (row-major, ``pe = i * r + j``).  The semantics are those of
``repro.core.shmem.ShmemGrid``:

  * ``put`` is the permutation along dim 0; a PE that receives nothing gets
    zeros, as ``ppermute`` gives.
  * Row/column collectives are grouped reductions or concatenations over
    the q (or r) PEs of a grid column (or row), broadcast back to the group.
  * ``barrier_all`` is a no-op: every op here has completed, in stream
    order, when the next one starts.

Each communication op adds its per-PE result bytes to ``comm_bytes`` — what
``repro.core.hybrid.collective_bytes_from_hlo`` counts per participant —
so the wire traffic of a program can be read off the grid.  ``flops``
is added to by the local products of :mod:`repro_torch.core.cannon`.
At q = r = 1 every op is the identity.  Everything is differentiable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class GridGeometry:
    """The PE arithmetic of a ``q x r`` grid, shared by the stacked
    :class:`ShmemGrid` and the process grid
    (:class:`repro_torch.core.pe_grid.PeGrid`): row-major ``pe = i * r +
    j``, and the permutations as lists of (source, destination) PEs."""

    q: int
    r: int

    @property
    def n_pes(self) -> int:
        return self.q * self.r

    def _pairs(self, dst_of_src) -> List[Tuple[int, int]]:
        return [(pe, int(dst_of_src(pe))) for pe in range(self.n_pes)]

    def row_shift_pairs(self, amount: int) -> List[Tuple[int, int]]:
        """Cyclic shift along grid rows: data at (i, j) moves to
        (i - amount mod q, j).  ``amount`` = +1 is Cannon's "shift B up"."""
        def dst(pe):
            i, j = divmod(pe, self.r)
            return ((i - amount) % self.q) * self.r + j
        return self._pairs(dst)

    def col_shift_pairs(self, amount: int) -> List[Tuple[int, int]]:
        """Cyclic shift along grid cols: data at (i, j) moves to
        (i, j - amount mod r).  ``amount`` = +1 is Cannon's "shift A left"."""
        def dst(pe):
            i, j = divmod(pe, self.r)
            return i * self.r + ((j - amount) % self.r)
        return self._pairs(dst)

    def skew_a_pairs(self) -> List[Tuple[int, int]]:
        """Cannon initial skew of A: block (i, j) -> (i, j - i)."""
        def dst(pe):
            i, j = divmod(pe, self.r)
            return i * self.r + ((j - i) % self.r)
        return self._pairs(dst)

    def skew_b_pairs(self) -> List[Tuple[int, int]]:
        """Cannon initial skew of B: block (i, j) -> (i - j, j)."""
        def dst(pe):
            i, j = divmod(pe, self.r)
            return ((i - j) % self.q) * self.r + j
        return self._pairs(dst)

    def unskew_a_pairs(self) -> List[Tuple[int, int]]:
        def dst(pe):
            i, j = divmod(pe, self.r)
            return i * self.r + ((j + i) % self.r)
        return self._pairs(dst)

    def unskew_b_pairs(self) -> List[Tuple[int, int]]:
        def dst(pe):
            i, j = divmod(pe, self.r)
            return ((i + j) % self.q) * self.r + j
        return self._pairs(dst)

    def transpose_pairs(self) -> List[Tuple[int, int]]:
        """Grid transpose: block (i, j) -> (j, i).  Requires q == r."""
        if self.q != self.r:
            raise ValueError("transpose needs a square grid")

        def dst(pe):
            i, j = divmod(pe, self.r)
            return j * self.r + i
        return self._pairs(dst)


class ShmemGrid(GridGeometry):
    """A logical ``q x r`` PE grid over the leading dimension of a stack.

    Row-major embedding: ``pe = i * r + j`` with ``i`` the grid row (``mx``,
    shards the token/seq dim) and ``j`` the grid col (``my``, shards the
    feature dim)."""

    def __init__(self, q: int, r: Optional[int] = None):
        self.q = int(q)
        self.r = int(r if r is not None else q)
        if self.q < 1 or self.r < 1:
            raise ValueError(f"grid {q}x{r} must be at least 1x1")
        self.comm_bytes = 0      # per-PE result bytes of every op so far
        self.flops = 0           # per-PE FLOPs of the local products so far
        # device index tensors of the permutations used so far: building one
        # from a list is a host-to-device copy, which waits for the stream
        self._indices = {}

    # -- identity ---------------------------------------------------------
    def my_pe(self, like: torch.Tensor) -> torch.Tensor:
        """PE ids shaped ``(n_pes, 1, ..., 1)`` to broadcast against the
        stack ``like``, on its device."""
        pe = torch.arange(self.n_pes, device=like.device)
        return pe.reshape((self.n_pes,) + (1,) * (like.ndim - 1))

    def my_coords(self, like: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        pe = self.my_pe(like)
        return pe // self.r, pe % self.r

    # -- helpers over the stack ----------------------------------------------
    def _check(self, x: torch.Tensor) -> None:
        if x.ndim < 1 or x.shape[0] != self.n_pes:
            raise ValueError(f"expected a stack of {self.n_pes} PE blocks, "
                             f"got shape {tuple(x.shape)}")

    def _count(self, block: torch.Tensor) -> None:
        """Add one PE's result bytes (``block`` is one PE's result)."""
        self.comm_bytes += block.numel() * block.element_size()

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        """(q*r, ...) -> (q, r, ...)."""
        return x.reshape((self.q, self.r) + tuple(x.shape[1:]))

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        """(q, r, ...) -> (q*r, ...)."""
        return x.reshape((self.n_pes,) + tuple(x.shape[2:]))

    @staticmethod
    def _axis(axis: int, x: torch.Tensor) -> int:
        """A block axis (negative counts from the end) -> the stack's."""
        nd = x.ndim - 1
        if not -nd <= axis < nd:
            raise ValueError(f"axis {axis} outside a {nd}-d block")
        return axis % nd + 1

    # -- one-sided communication (shmem_put analogues) ---------------------
    def put(self, x: torch.Tensor, pairs: Sequence[Tuple[int, int]]
            ) -> torch.Tensor:
        """``shmem_put`` of every PE's whole block along ``pairs`` of
        (source, destination) PEs; a PE that receives nothing gets zeros."""
        self._check(x)
        src = [-1] * self.n_pes
        for s, d in pairs:
            if src[d] != -1:
                raise ValueError(f"PE {d} receives twice in {pairs}")
            src[d] = s
        if -1 not in src:
            out = x.index_select(0, self._index(src, x.device))
        else:
            keep = [d for d in range(self.n_pes) if src[d] != -1]
            picked = x.index_select(0, self._index([src[d] for d in keep],
                                                   x.device))
            out = torch.zeros_like(x).index_copy(
                0, self._index(keep, x.device), picked)
        self._count(out[0])
        return out

    def _index(self, ids: List[int], device: torch.device) -> torch.Tensor:
        key = (tuple(ids), device)
        if key not in self._indices:
            self._indices[key] = torch.tensor(ids, device=device)
        return self._indices[key]

    def shift_rows(self, x: torch.Tensor, amount: int = 1) -> torch.Tensor:
        return self.put(x, self.row_shift_pairs(amount))

    def shift_cols(self, x: torch.Tensor, amount: int = 1) -> torch.Tensor:
        return self.put(x, self.col_shift_pairs(amount))

    # -- collectives over grid sub-axes ------------------------------------
    def _reduce(self, x: torch.Tensor, dim: Optional[int], op: str
                ) -> torch.Tensor:
        """Grouped reduction broadcast back to the group: ``dim`` 0 reduces
        over grid rows (a column's q PEs), 1 over grid cols, None over all."""
        self._check(x)
        g = self._grid(x)
        dims = (0, 1) if dim is None else (dim,)
        if op == "sum":
            red = g.sum(dim=dims, keepdim=True)
        else:
            red = g.amax(dim=dims, keepdim=True)
        out = self._flat(red.expand_as(g).contiguous())
        self._count(out[0])
        return out

    def psum_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the grid-col (my / feature) dimension, replicated across
        each row's r PEs."""
        return self._reduce(x, 1, "sum")

    def psum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the grid-row (mx / seq) dimension."""
        return self._reduce(x, 0, "sum")

    def pmax_cols(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, 1, "max")

    def pmax_cols_sg(self, x: torch.Tensor) -> torch.Tensor:
        """pmax over grid cols with a zero gradient (softmax max-shifts are
        gradient-neutral)."""
        return self._reduce(x.detach(), 1, "max")

    def psum_all(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, None, "sum")

    def _gather(self, x: torch.Tensor, dim: Optional[int], axis: int,
                tiled: bool) -> torch.Tensor:
        """fcollect within each group: ``dim`` 0 gathers a column's q blocks
        (in row order), 1 a row's r blocks, None all PEs; concatenated along
        block ``axis`` (``tiled``) or stacked on a new one."""
        self._check(x)
        # untiled, a negative axis counts in the result's rank, as in JAX
        ax = self._axis(axis, x) if tiled or axis >= 0 \
            else axis % x.ndim + 1
        g = self._grid(x)
        if dim is None:
            parts = list(x.unbind(0))
        else:
            parts = list(g.unbind(dim))           # each (r, ...) or (q, ...)
        join = torch.cat if tiled else torch.stack
        if dim is None:
            whole = join(parts, dim=ax - 1)
            out = whole.unsqueeze(0).expand(
                (self.n_pes,) + tuple(whole.shape)).contiguous()
        else:
            whole = join(parts, dim=ax)           # (r or q, gathered block)
            out = self._flat(whole.unsqueeze(dim).expand(
                (self.q, self.r) + tuple(whole.shape[1:])).contiguous())
        self._count(out[0])
        return out

    def all_gather_rows(self, x: torch.Tensor, axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
        """fcollect over the grid-row (mx) dimension: concatenates the q
        blocks held along a column."""
        return self._gather(x, 0, axis, tiled)

    def all_gather_cols(self, x: torch.Tensor, axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
        return self._gather(x, 1, axis, tiled)

    def all_gather_flat(self, x: torch.Tensor, axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
        return self._gather(x, None, axis, tiled)

    def _reduce_scatter(self, x: torch.Tensor, dim: int, axis: int
                        ) -> torch.Tensor:
        """Sum within each group, then PE number k of the group (its grid
        row for ``dim`` 0, its column for 1) keeps chunk k along ``axis``."""
        self._check(x)
        ax = self._axis(axis, x)
        n = (self.q, self.r)[dim]
        if x.shape[ax] % n:
            raise ValueError(f"axis {axis} of size {x.shape[ax]} does not "
                             f"split into {n} chunks")
        red = self._grid(x).sum(dim=dim)          # (r or q, block)
        chunks = red.chunk(n, dim=ax)             # chunk k -> group member k
        out = torch.stack(chunks, dim=dim)        # (q, r, chunk)
        out = self._flat(out.contiguous())
        self._count(out[0])
        return out

    def reduce_scatter_rows(self, x: torch.Tensor, axis: int = 0
                            ) -> torch.Tensor:
        return self._reduce_scatter(x, 0, axis)

    def reduce_scatter_cols(self, x: torch.Tensor, axis: int = 0
                            ) -> torch.Tensor:
        return self._reduce_scatter(x, 1, axis)

    def all_to_all_rows(self, x: torch.Tensor, split_axis: int,
                        concat_axis: int) -> torch.Tensor:
        """MoE dispatch/combine exchange along the grid-row (mx) dimension:
        PE (k, j) splits its block into q chunks along ``split_axis`` and
        sends chunk i to PE (i, j), which concatenates what it receives, in
        source order, along ``concat_axis``."""
        self._check(x)
        sa, ca = self._axis(split_axis, x), self._axis(concat_axis, x)
        if x.shape[sa] % self.q:
            raise ValueError(f"split axis of size {x.shape[sa]} does not "
                             f"split into {self.q} chunks")
        g = self._grid(x)                                 # (qs, r, blk)
        t = torch.stack(g.chunk(self.q, dim=sa + 1), 0)   # (qd, qs, r, blk')
        # move the source dim next to the concat axis, then merge the two
        t = t.movedim(1, ca + 1)                          # (qd, r, .., qs, c, ..)
        shape = list(t.shape)
        shape[ca + 1:ca + 3] = [shape[ca + 1] * shape[ca + 2]]
        out = self._flat(t.reshape(shape))
        self._count(out[0])
        return out

    # -- synchronization ----------------------------------------------------
    def barrier_all(self, *arrays):
        """``shmem_barrier_all``: a no-op that hands its operands back (every
        op above has completed, in stream order, before the next starts)."""
        if not arrays:
            return None
        return arrays[0] if len(arrays) == 1 else arrays

    def broadcast_from(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """``shmem_broadcast`` from flat PE ``root`` to all PEs: a masked
        sum, as in the JAX grid."""
        mask = (self.my_pe(x) == root).to(x.dtype)
        return self.psum_all(x * mask)
