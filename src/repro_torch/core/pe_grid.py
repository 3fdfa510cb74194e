"""One process's view of a ``q x r`` grid of PE processes.

The JAX package runs a model inside ``shard_map``: every device of the
mesh runs the same program on its own blocks, and ``repro.core.shmem.
ShmemGrid`` gives that program OpenSHMEM's view (``my_pe``, puts along
permutations, row and column reductions and gathers).  In the port a PE is
a process (:mod:`repro_torch.runtime.pe` starts them), so :class:`PeGrid`
has the same method names and the same semantics on LOCAL blocks:

  * ``put(x, pairs)``: PE s writes its block into PE d's heap for every
    (s, d); a PE that receives nothing gets zeros, as ``ppermute`` gives.
  * ``psum_rows``/``psum_cols``/``pmax_rows``/``pmax_cols``: every member
    of the group (a grid column for ``rows``, a grid row for ``cols``) puts
    its block into slot k of every member's heap, k its place in the
    group; after the barrier each member reduces its own slots in slot
    order with an fp32 accumulator (``shmem_reduce_slots``), so all get
    the same bits.
  * ``psum_all`` over every PE and ``psum_groups`` over a partition of
    the PEs (``axis_index_groups``) likewise, on a heap of ``n_pes``
    slots a half; integer payloads are summed exactly in their dtype.
  * ``all_gather_rows``/``all_gather_cols``: the same puts, then the slots
    concatenated in group order; ``reduce_scatter_rows``/``_cols``: chunk
    m of every block goes to member m, which sums what it receives.
  * ``broadcast_from(x, root)``: the root puts to every PE.
  * ``all_to_all(x)``: the flat exchange over every PE (``lax.all_to_all``
    with ``split_axis=0, concat_axis=0, tiled=True``): block p of x's
    leading axis goes into slot (this PE) of PE p's heap, and each PE
    reads its slots in source-PE order.
  * ``barrier_all``: the card's stream synchronised, then the host barrier
    (:class:`repro_torch.runtime.pe.HostBarrier`).

Every collective is: puts, one barrier, then a local reduction or copy.
Before the barrier each PE synchronises its stream, so its puts have
landed; after it each PE reads its own heap, so it sees every put of the
collective.  Collective k uses half ``k % 2`` of the heap: a PE that runs
ahead puts collective k+1 into the other half while a slow one still reads
k, and collective k+2 comes after barrier k+1, which the slow PE passes
only once its reads of k are done.  The heap (:mod:`repro_torch.kernels.
shmem_heap`) is sized once, before the first collective (:meth:`reserve`):
each half holds ``max(q, r)`` slots, or ``n_pes`` where the flat exchange
runs.

Every collective is differentiable, with the transpose JAX takes inside
``shard_map(..., check_vma=False)`` as its backward (itself a collective
of the grid, run by :class:`_Collective` when autograd reaches it): a put
along the inverted pairs; a psum (rows, cols, ``psum_all``,
``psum_groups``) the same psum, so a cotangent replicated over the group
comes back multiplied by its size (JAX's grid step reports gradients q*r
times the model's for this reason, and the port follows it); a gather
the tiled reduce-scatter over its group and back; ``all_to_all`` itself;
``broadcast_from`` (JAX's ``psum_all(x * mask)``) a ``psum_all``, then
the mask.  ``pmax_rows``/``pmax_cols`` take no gradient (the zero tangent
of ``pmax_cols_sg``).  Every PE must then run the same backward
collectives in the same order, so a program must build the same graph on
every PE (masks by multiplication, loops of a fixed length); the host
barrier compares the PEs' collective names and ordinals and raises on a
mismatch.

``comm_bytes`` counts each op's per-PE result bytes, as the stacked
:class:`~repro_torch.core.shmem.ShmemGrid` does; ``heap_bytes`` the bytes
this PE's puts wrote into heaps (its own included); ``wait_s`` the host
time spent synchronising and in barriers.  At q = r = 1 every op returns
its input and does no device work.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.shmem import GridGeometry
from repro_torch.kernels.shmem_heap import (CpuHeap, CudaHeap, shmem_put,
                                            shmem_reduce_slots, slot)

ALIGN = 256                       # bytes: every slot starts on this


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _Collective(torch.autograd.Function):
    """A collective whose backward is its transpose, another collective
    of the grid: every PE runs it, in the order autograd reaches it,
    which is the same on every PE when the graphs are."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


class PeGrid(GridGeometry):
    """PE ``pe`` of a ``q x r`` grid (row-major ``pe = i * r + j``).

    ``comm`` is the host side of the grid (``barrier(what)``,
    ``all_gather_object(obj)``, ``broadcast(tensor, src)``;
    :class:`repro_torch.runtime.pe.GlooComm`), None at 1x1.  ``workdir``
    holds the heaps' files on the CPU."""

    def __init__(self, pe: int, q: int, r: int, *, device,
                 comm=None, workdir: Optional[str] = None):
        self.pe, self.q, self.r = int(pe), int(q), int(r)
        if not 0 <= self.pe < self.n_pes:
            raise ValueError(f"PE {pe} outside a {q}x{r} grid")
        if self.n_pes > 1 and comm is None:
            raise ValueError("a grid of several PEs needs its comm")
        self.device = torch.device(device)
        self.comm, self.workdir = comm, workdir
        self.heap = None
        self.slot_bytes = 0
        self.n_slots = 0          # slots a half of the heap holds
        self._parity = 0
        self.comm_bytes = 0       # per-PE result bytes of every op so far
        self.heap_bytes = 0       # bytes this PE's puts wrote into heaps
        self.n_collectives = 0
        self.n_puts = 0
        self.wait_s = 0.0         # stream synchronise + host barrier
        self.moe_pairs = 0        # pairs this PE's grid MoE layers routed
        self.moe_dropped = 0      # and dropped at capacity
        self._dropped: List[torch.Tensor] = []   # device counts not read

    # -- identity ---------------------------------------------------------
    def my_pe(self) -> int:
        return self.pe

    def my_coords(self) -> Tuple[int, int]:
        return divmod(self.pe, self.r)

    @property
    def local(self) -> bool:
        """True on a 1x1 grid, where every op is the identity."""
        return self.n_pes == 1

    def row_members(self) -> List[int]:
        """The PEs of this PE's grid column (a ``*_rows`` collective's
        group), in row order."""
        _, j = self.my_coords()
        return [i * self.r + j for i in range(self.q)]

    def col_members(self) -> List[int]:
        """The PEs of this PE's grid row (a ``*_cols`` group)."""
        i, _ = self.my_coords()
        return [i * self.r + j for j in range(self.r)]

    # -- the heap -----------------------------------------------------------
    @staticmethod
    def heap_size(slot_bytes: int, q: int, r: int,
                  all_to_all: bool = False) -> int:
        """Bytes of one PE's heap whose slots hold ``slot_bytes``: two
        halves (collective parity) of ``max(q, r)`` slots each, or of
        ``q * r`` with ``all_to_all`` (the flat exchange's)."""
        slot_bytes = -(-int(slot_bytes) // ALIGN) * ALIGN
        return 2 * (q * r if all_to_all else max(q, r)) * slot_bytes

    def reserve(self, slot_bytes: int, all_to_all: bool = False) -> int:
        """Allocate this PE's heap with slots of ``slot_bytes`` (the
        largest message a collective will carry), ``n_pes`` of them a half
        with ``all_to_all`` (else ``max(q, r)``), and map every peer's: a
        collective call, once, before the first collective.  Returns the
        heap's bytes."""
        if self.local:
            return 0
        if self.heap is not None:
            raise RuntimeError("the heap is sized once, before the first "
                               "collective")
        self.slot_bytes = -(-int(slot_bytes) // ALIGN) * ALIGN
        self.n_slots = self.n_pes if all_to_all else max(self.q, self.r)
        n = self.heap_size(self.slot_bytes, self.q, self.r, all_to_all)
        if self.device.type == "cuda":
            heap = CudaHeap(self.pe, self.n_pes, n, self.device)
        else:
            heap = CpuHeap(self.pe, self.n_pes, n, self.workdir)
        heap.open_peers(self.comm.all_gather_object(heap.handle))
        self.heap = heap
        self.comm.barrier()
        return n

    def close(self) -> None:
        """Unmap the peers' heaps and free this one (collective)."""
        if self.heap is None:
            return
        self._sync()
        self.comm.barrier()          # every put has landed
        self.heap.close_peers()
        self.comm.barrier()          # every peer has unmapped this heap
        self.heap.free()
        self.heap = None

    def _offset(self, k: int) -> int:
        half = self._parity * self.n_slots * self.slot_bytes
        return half + k * self.slot_bytes

    def _check_fits(self, nbytes: int, what: str) -> None:
        if self.heap is None:
            raise RuntimeError(f"{what}: the heap was never reserved")
        if nbytes > self.slot_bytes:
            raise RuntimeError(
                f"{what}: a {nbytes}-byte message exceeds the heap's "
                f"{self.slot_bytes}-byte slots; reserve at least that")

    def _put(self, x: torch.Tensor, dst: int, k: int) -> None:
        shmem_put(self.heap, x, dst, self._offset(k))
        self.heap_bytes += _nbytes(x)
        self.n_puts += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _barrier(self, what: str = "barrier_all") -> None:
        t0 = time.perf_counter()
        self._sync()
        self.comm.barrier(f"{what} #{self.n_collectives}")
        self.wait_s += time.perf_counter() - t0

    def _done(self, out: torch.Tensor) -> torch.Tensor:
        self._parity ^= 1
        self.n_collectives += 1
        self.comm_bytes += _nbytes(out)
        return out

    def _read(self, k: int, shape, dtype) -> torch.Tensor:
        return slot(self.heap.views[self.pe], self._offset(k), tuple(shape),
                    dtype).clone()

    def _diff(self, x: torch.Tensor, fwd, bwd) -> torch.Tensor:
        """``fwd(x)``, with ``bwd`` (the transpose, itself a collective) as
        its backward when autograd records x."""
        if not self.local and torch.is_grad_enabled() and x.requires_grad:
            return _Collective.apply(x, fwd, bwd)
        return fwd(x)

    # -- one-sided communication (shmem_put analogues) ---------------------
    def put(self, x: torch.Tensor, pairs: Sequence[Tuple[int, int]]
            ) -> torch.Tensor:
        """``shmem_put`` along ``pairs`` of (source, destination) PEs: this
        PE's block goes to its destination; it returns what its source
        sent (zeros when none).  Backward: the put along the inverted
        pairs (a PE that sent nothing gets zeros)."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        inverse = [(d, s) for s, d in pairs]
        return self._diff(x, lambda t: self._put_raw(t, pairs),
                          lambda g: self.put(g, inverse))

    def _put_raw(self, x: torch.Tensor, pairs) -> torch.Tensor:
        srcs: Dict[int, int] = {}
        for s, d in pairs:
            if d in srcs:
                raise ValueError(f"PE {d} receives twice in {pairs}")
            srcs[d] = s
        if self.local:
            return x if srcs.get(0) == 0 else torch.zeros_like(x)
        x = x.contiguous()
        self._check_fits(_nbytes(x), "put")
        dst = next((d for s, d in pairs if s == self.pe), None)
        if dst is not None:
            self._put(x, dst, 0)
        self._barrier("put")
        out = self._read(0, x.shape, x.dtype) if self.pe in srcs \
            else torch.zeros_like(x)
        return self._done(out)

    def shift_rows(self, x: torch.Tensor, amount: int = 1) -> torch.Tensor:
        return self.put(x, self.row_shift_pairs(amount))

    def shift_cols(self, x: torch.Tensor, amount: int = 1) -> torch.Tensor:
        return self.put(x, self.col_shift_pairs(amount))

    # -- collectives over grid sub-axes ------------------------------------
    def _scatter_puts(self, x: torch.Tensor, members: List[int],
                      what: str) -> torch.Tensor:
        """Put this PE's block into slot (its place in ``members``) of
        every member's heap, then the barrier."""
        x = x.contiguous()
        self._check_fits(_nbytes(x), what)
        if len(members) > self.n_slots:
            raise RuntimeError(f"{what}: {len(members)} members, the heap's "
                               f"halves hold {self.n_slots} slots (reserve "
                               f"with all_to_all for the flat groups)")
        k = members.index(self.pe)
        for m in members:
            self._put(x, m, k)
        self._barrier(what)
        return x

    def _reduce_raw(self, x: torch.Tensor, members: List[int], op: str,
                    what: str) -> torch.Tensor:
        if self.local:
            return x
        x = self._scatter_puts(x, members, what)
        if x.dtype not in (torch.float32, torch.bfloat16):
            # integer payloads (compressed_psum's codes): summed exactly
            # in slot order, in their own dtype
            out = self._read(0, x.shape, x.dtype)
            for k in range(1, len(members)):
                v = self._read(k, x.shape, x.dtype)
                out = torch.maximum(out, v) if op == "max" else out + v
            return self._done(out)
        out = shmem_reduce_slots(self.heap, self._offset(0), self.slot_bytes,
                                 len(members), tuple(x.shape), x.dtype,
                                 x.dtype, op)
        return self._done(out)

    def _psum(self, x: torch.Tensor, members: List[int],
              what: str) -> torch.Tensor:
        """The sum over ``members`` (this PE among them); its transpose is
        the same sum (JAX's ``psum`` transpose under ``check_vma=False``:
        a replicated cotangent comes back multiplied by the group's
        size)."""
        return self._diff(x, lambda t: self._reduce_raw(t, members, "sum",
                                                        what),
                          lambda g: self._psum(g, members, what))

    def psum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the grid rows of this PE's column, replicated there."""
        return self._psum(x, self.row_members(), "psum_rows")

    def psum_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the grid cols of this PE's row, replicated there."""
        return self._psum(x, self.col_members(), "psum_cols")

    def psum_all(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every PE (a heap reserved with ``all_to_all``: n_pes
        slots a half)."""
        return self._psum(x, list(range(self.n_pes)), "psum_all")

    def psum_groups(self, x: torch.Tensor, groups: Sequence[Sequence[int]]
                    ) -> torch.Tensor:
        """Sum over this PE's group of ``groups`` (a partition of the PEs,
        each in ascending PE order: ``lax.psum(..., axis_index_groups=)``);
        a PE in no group keeps its block."""
        mine = next((sorted(int(p) for p in g) for g in groups
                     if self.pe in g), [self.pe])
        return self._psum(x, mine, "psum_groups")

    def pmax_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the grid rows (the axis paged KV pages shard on); no
        gradient."""
        if self.local:
            return x
        return self._reduce_raw(x.detach(), self.row_members(), "max",
                                "pmax_rows")

    def pmax_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the grid cols (the loss's column-sharded vocabulary:
        a forward max with a zero tangent, as ``pmax_cols_sg`` computes
        it): no gradient reaches ``x``."""
        if self.local:
            return x
        return self._reduce_raw(x.detach(), self.col_members(), "max",
                                "pmax_cols")

    def _gather_raw(self, x: torch.Tensor, members: List[int], axis: int,
                    tiled: bool, what: str) -> torch.Tensor:
        if self.local:
            return x if tiled else x.unsqueeze(axis)
        x = self._scatter_puts(x, members, what)
        parts = [self._read(k, x.shape, x.dtype) for k in range(len(members))]
        out = torch.cat(parts, dim=axis) if tiled \
            else torch.stack(parts, dim=axis)
        return self._done(out)

    def _gather(self, x: torch.Tensor, members: List[int], axis: int,
                tiled: bool, what: str, scatter: str) -> torch.Tensor:
        """Backward: the tiled reduce-scatter over the same group (of the
        stacked axis' members, then squeezed, when not ``tiled``)."""
        axis = axis % (x.dim() + (0 if tiled else 1))

        def bwd(g):
            if tiled:
                return self._reduce_scatter(g, members, axis, scatter)
            return self._reduce_scatter(g, members, axis,
                                        scatter).squeeze(axis)
        return self._diff(x, lambda t: self._gather_raw(t, members, axis,
                                                        tiled, what), bwd)

    def all_gather_rows(self, x: torch.Tensor, axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
        """fcollect over the grid rows: the q blocks of this PE's column,
        in row order, concatenated along ``axis`` (or stacked)."""
        return self._gather(x, self.row_members(), axis, tiled,
                            "all_gather_rows", "reduce_scatter_rows")

    def all_gather_cols(self, x: torch.Tensor, axis: int = 0,
                        tiled: bool = True) -> torch.Tensor:
        return self._gather(x, self.col_members(), axis, tiled,
                            "all_gather_cols", "reduce_scatter_cols")

    def _reduce_scatter_raw(self, x: torch.Tensor, members: List[int],
                            axis: int, what: str) -> torch.Tensor:
        n = len(members)
        if self.local:
            return x
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                             f"split into {n} chunks")
        chunks = [c.contiguous() for c in x.chunk(n, dim=axis)]
        self._check_fits(_nbytes(chunks[0]), what)
        k = members.index(self.pe)
        for m, c in zip(members, chunks):
            self._put(c, m, k)
        self._barrier(what)
        shape = tuple(chunks[0].shape)
        out = shmem_reduce_slots(self.heap, self._offset(0), self.slot_bytes,
                                 n, shape, x.dtype, x.dtype, "sum")
        return self._done(out)

    def _reduce_scatter(self, x: torch.Tensor, members: List[int],
                        axis: int, what: str) -> torch.Tensor:
        """Backward: the tiled all-gather over the same group."""
        axis = axis % x.dim()
        gather = "all_gather_rows" if what.endswith("rows") \
            else "all_gather_cols"
        return self._diff(
            x, lambda t: self._reduce_scatter_raw(t, members, axis, what),
            lambda g: self._gather(g, members, axis, True, gather, what))

    def reduce_scatter_rows(self, x: torch.Tensor, axis: int = 0
                            ) -> torch.Tensor:
        """Sum over this PE's column; grid row k keeps chunk k along
        ``axis``."""
        return self._reduce_scatter(x, self.row_members(), axis,
                                    "reduce_scatter_rows")

    def reduce_scatter_cols(self, x: torch.Tensor, axis: int = 0
                            ) -> torch.Tensor:
        """Sum over this PE's grid row; grid col k keeps chunk k along
        ``axis``."""
        return self._reduce_scatter(x, self.col_members(), axis,
                                    "reduce_scatter_cols")

    def broadcast_from(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """``shmem_broadcast``: every PE gets PE ``root``'s block (``x``
        gives the shape and dtype everywhere).  Backward: JAX's
        ``psum_all(x * mask)`` transposed, a ``psum_all`` then the mask
        (the cotangents of every PE summed onto the root's block)."""
        mine = self.pe == root

        def bwd(g):
            s = self.psum_all(g)
            return s if mine else torch.zeros_like(s)
        return self._diff(x, lambda t: self._broadcast_raw(t, root), bwd)

    def _broadcast_raw(self, x: torch.Tensor, root: int) -> torch.Tensor:
        if self.local:
            return x
        x = x.contiguous()
        self._check_fits(_nbytes(x), "broadcast_from")
        if self.pe == root:
            for m in range(self.n_pes):
                self._put(x, m, 0)
        self._barrier("broadcast_from")
        return self._done(self._read(0, x.shape, x.dtype))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The flat exchange over every PE: x (n_pes * m, ...) splits
        into n_pes blocks along axis 0, block p goes to PE p, and the
        result stacks the blocks received in source-PE order (an MoE
        layer's dispatch and combine).  Needs a heap reserved with
        ``all_to_all``; any dtype (the put copies bytes).  Its own
        transpose."""
        return self._diff(x, self._all_to_all_raw, self.all_to_all)

    def _all_to_all_raw(self, x: torch.Tensor) -> torch.Tensor:
        if self.local:
            return x
        n = self.n_pes
        if x.shape[0] % n:
            raise ValueError(f"axis 0 of size {x.shape[0]} does not split "
                             f"into {n} blocks")
        if self.n_slots < n:
            raise RuntimeError("all_to_all: the heap was reserved without "
                               "the flat exchange's n_pes slots")
        blocks = [b.contiguous() for b in x.chunk(n, dim=0)]
        self._check_fits(_nbytes(blocks[0]), "all_to_all")
        for p, b in enumerate(blocks):
            self._put(b, p, self.pe)
        self._barrier("all_to_all")
        shape = tuple(blocks[0].shape)
        out = torch.cat([self._read(k, shape, x.dtype) for k in range(n)])
        return self._done(out)

    # -- synchronization ----------------------------------------------------
    def barrier_all(self, *arrays):
        """``shmem_barrier_all``: this PE's stream synchronised, then every
        PE meets; hands its operands back."""
        if not self.local:
            self._barrier()
        if not arrays:
            return None
        return arrays[0] if len(arrays) == 1 else arrays

    def note_drops(self, pairs: int, dropped: torch.Tensor) -> None:
        """A grid MoE layer routed ``pairs`` pairs and dropped ``dropped``
        of them (a count on the device, read with the next
        :meth:`counters`)."""
        self.moe_pairs += pairs
        self._dropped.append(dropped)

    def counters(self) -> Dict[str, float]:
        """The grid's running counts (the engine reads deltas per step,
        after the step's stream is synchronised)."""
        if self._dropped:
            self.moe_dropped += int(torch.stack(self._dropped).sum())
            self._dropped = []
        return {"collectives": self.n_collectives, "puts": self.n_puts,
                "heap_bytes": self.heap_bytes, "comm_bytes": self.comm_bytes,
                "wait_s": self.wait_s, "moe_pairs": self.moe_pairs,
                "moe_dropped": self.moe_dropped}


def probe_collectives(grid: PeGrid, inputs: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Run every collective of :class:`PeGrid` once on this PE's block of
    each stacked input (``inputs[name][pe]``) and return the results as
    numpy: the grid's check against ``repro.core.shmem.ShmemGrid`` (the
    CPU tests) and on the card (``chip_smoke.py``).  ``inputs`` holds
    ``x`` (n_pes, M, N) and, for gemv2d, ``vec`` (n_pes, M, K) and
    ``w`` (n_pes, K, N)."""
    from repro_torch.core.cannon import gemv2d
    dev = grid.device

    def blk(name):
        a = np.ascontiguousarray(inputs[name][grid.pe])
        return torch.from_numpy(a).to(dev)

    x = blk("x")
    largest = max(_nbytes(x), _nbytes(blk("vec")),
                  4 * inputs["vec"].shape[1] * inputs["w"].shape[2])
    grid.reserve(largest, all_to_all=True)
    out = {
        "transpose": grid.put(x, grid.transpose_pairs()),
        "shift_rows": grid.shift_rows(x, 1),
        "shift_cols": grid.shift_cols(x, 1),
        "psum_rows": grid.psum_rows(x),
        "psum_cols": grid.psum_cols(x),
        "pmax_rows": grid.pmax_rows(x),
        "all_gather_rows": grid.all_gather_rows(x, axis=0),
        "all_gather_cols": grid.all_gather_cols(x, axis=-1),
        "reduce_scatter_rows": grid.reduce_scatter_rows(x, axis=0),
        "broadcast_from": grid.broadcast_from(x, 1 % grid.n_pes),
        "gemv2d": gemv2d(grid, blk("vec"), blk("w")),
        "all_to_all": grid.all_to_all(x),
        # the MoE int8 wire's payload and its expert ids take the byte path
        "all_to_all_int8": grid.all_to_all(
            torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)),
        "all_to_all_int32": grid.all_to_all((x * 1000).to(torch.int32)),
    }
    grid.barrier_all()
    return {k: v.cpu().numpy() for k, v in out.items()}


def probe_latency(grid: PeGrid, n: int = 200, numel: int = 8 * 4864
                  ) -> Dict[str, float]:
    """Mean microseconds a PE spends in the parts of one collective, over
    ``n`` repetitions each: the host barrier alone, the stream synchronise
    alone, a put of ``numel`` fp32 along the transpose, and a
    ``psum_rows`` of that many (the engine's decode-step gate|up message
    at the default).  What a grid step's wall is made of."""
    x = torch.ones(numel, dtype=torch.float32, device=grid.device)
    grid.reserve(x.numel() * 4)

    def mean_us(fn):
        fn()
        grid.barrier_all()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    out = {"barrier_us": mean_us(grid.comm.barrier),
           "sync_us": mean_us(grid._sync),
           "put_us": mean_us(lambda: grid.put(x, grid.transpose_pairs())),
           "psum_rows_us": mean_us(lambda: grid.psum_rows(x))}
    grid.barrier_all()
    return out


def grad_probe_pairs(grid: PeGrid) -> List[Tuple[int, int]]:
    """A put in which PE 0 receives nothing and the last PE sends
    nothing: PE p to PE p+1."""
    return [(p, p + 1) for p in range(grid.n_pes - 1)]


def probe_collective_grads(grid: PeGrid, inputs: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """The backward of every differentiable collective of :class:`PeGrid`
    on this PE's block of ``inputs["x"]`` (n_pes, M, N): for each op, the
    gradient of ``sum(op(x) * ct)`` with respect to x, ``ct`` this PE's
    block of ``inputs["ct_" + op]``; also ``compressed_psum`` of
    ``inputs["g"]`` with the residual ``inputs["resid"]`` over
    ``psum_all`` (its sum and new residual).  The grid's check against
    ``jax.vjp`` of ``repro.core.shmem.ShmemGrid``'s ops under
    ``shard_map`` (the CPU tests)."""
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.train.step import _replica_groups
    dev = grid.device

    def blk(name):
        a = np.ascontiguousarray(inputs[name][grid.pe])
        return torch.from_numpy(a).to(dev)

    x0 = blk("x")
    grid.reserve(1 << 16, all_to_all=True)
    groups = _replica_groups(grid.q, grid.r, grid.r, True)
    ops = {
        "transpose": lambda x: grid.put(x, grid.transpose_pairs()),
        "shift_rows": lambda x: grid.shift_rows(x, 1),
        "shift_cols": lambda x: grid.shift_cols(x, 1),
        "put_partial": lambda x: grid.put(x, grad_probe_pairs(grid)),
        "psum_rows": grid.psum_rows,
        "psum_cols": grid.psum_cols,
        "psum_all": grid.psum_all,
        "psum_groups": lambda x: grid.psum_groups(x, groups),
        "all_gather_rows": lambda x: grid.all_gather_rows(x, axis=0),
        "all_gather_cols": lambda x: grid.all_gather_cols(x, axis=-1),
        "reduce_scatter_rows": lambda x: grid.reduce_scatter_rows(x, axis=0),
        "reduce_scatter_cols": lambda x: grid.reduce_scatter_cols(x,
                                                                  axis=-1),
        "all_to_all": grid.all_to_all,
        "broadcast_from": lambda x: grid.broadcast_from(x, 1 % grid.n_pes),
        "pmax_cols": grid.pmax_cols,
    }
    out = {}
    for name, op in ops.items():
        x = x0.clone().requires_grad_(True)
        y = op(x)
        if y.requires_grad:
            (g,) = torch.autograd.grad((y * blk("ct_" + name)).sum(), x)
        else:                       # no gradient reaches x
            g = torch.zeros_like(x)
        out[name] = g
        out[name + "_fwd"] = y.detach()
    out["compressed_psum"], out["compressed_psum_resid"] = compressed_psum(
        blk("g"), blk("resid"), psum_fn=grid.psum_all)
    grid.barrier_all()
    return {k: v.cpu().numpy() for k, v in out.items()}
