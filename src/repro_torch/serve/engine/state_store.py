"""Device-resident engine state, driven by the per-layer StateSpec list.

The store owns the ONE bucket-independent state arena the step bodies
consume — paged K/V leaves and dense slot leaves, one allocation per leaf on
the engine's device for the engine's whole lifetime — and every host-side
lifecycle operation on it (``repro.serve.engine.state_store`` at q = r = 1):

  * **admission**   — allocate a dense slot; zero it (fresh sequence) or
    physically copy a snapshot into it (prefix adoption, ``fork()``,
    preemption restore).  Pages are the scheduler/pool's job — the store
    only decides how far admission may fast-forward (``plan_resume``).
  * **prefix snapshots** — when a prefill launch lands exactly on the
    request's snapshot boundary (the last full-page boundary strictly
    inside its prompt), the engine publishes the dense leaves at that
    position keyed by the consumed token prefix.  Dense state is not
    ref-countable, so adoption *copies* the snapshot into the adopter's
    slot.
  * **preemption**  — on page-free (ssm-family) configs the victim's dense
    leaves are snapshotted onto the request for replay-free restore; on
    hybrid configs the snapshot is dropped (the attention KV is gone, so a
    consistent resume point must come from the prefix maps or position 0).

Prefix and preemption snapshots are host copies (CPU tensors), as the JAX
store keeps numpy arrays.  The speculative-decoding snapshot
(:meth:`StateStore.snapshot_slots`) holds the same values on the card: it
is taken and restored every verify round, where a host copy of every
active slot would cost as much as the step itself.  The scheduler routes
every lifecycle event through the hook face (``needs_pages`` /
``plan_resume`` / ``can_admit`` / ``commit_admit`` / ``on_release``);
:class:`NullStateHook` is that face for a scheduler with no state store at
all.

On a grid of PE processes every PE's arena is its own (the JAX controller's
``.at[].set`` writes one global array).  PE 0's store decides; with
:attr:`StateStore.commands` set it logs each operation on its arena as a
command ``(op, a, b)``: :data:`ZERO` a slot at admission, :data:`WRITE`
snapshot b into slot a (prefix adoption, preemption restore), :data:`READ`
slot a into snapshot b (a published prefix, a preempted page-free
request), :data:`DROP` snapshot a where PE 0 lets its copy go (FIFO or
tree eviction, a snapshot replaced, a preempted request's snapshot at its
readmission or its end).  PE 0 numbers its snapshots; the engine sends
the log to the other PEs before its next step, and each applies it to its
own shard (:meth:`StateStore.apply`), keeping its own host snapshots under
PE 0's numbers.  A follower decides nothing itself.
"""

from __future__ import annotations

from collections import Counter, OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.serve.engine.block_cache import DenseSlotPool
from repro_torch.serve.state import DenseSpec, ModelStateSpecs

HostLeaves = Dict[Tuple[int, str], torch.Tensor]

# the commands of a grid controller's store (module docstring)
ZERO, WRITE, READ, DROP = range(4)
COMMANDS = ("zero", "write", "read", "drop")


class Snapshot(dict):
    """Host leaves of one dense slot, numbered by a grid controller's
    store (``sid``) so the other PEs can name their copies."""
    __slots__ = ("sid",)


class StateStore:
    """One engine's resident device state + its lifecycle operations."""

    MAX_PREFIX_SNAPSHOTS = 64      # dense prefix snapshots kept (FIFO)

    def __init__(self, specs: ModelStateSpecs, *, n_blocks: int,
                 device: torch.device, n_slots: int = 1,
                 stride: Optional[int] = None, pool=None):
        self.specs = specs
        self.stride = stride if stride is not None else (
            specs.stride if specs.has_paged else None)
        if specs.has_dense and self.stride is None:
            raise ValueError("a dense-state model needs the engine's stride "
                             "(snapshot boundaries sit on page boundaries)")
        # hybrid configs key dense snapshots by the SAME radix tree node
        # that owns the prefix's last KV page, so the two state kinds can
        # never disagree about which prefixes are adoptable; page-free
        # configs, and pools without a cache, keep the token-tuple FIFO map
        self._tree = pool.cache if (pool is not None and specs.has_paged
                                    and pool.cache is not None) else None
        self._snap_nodes: "deque" = deque()   # FIFO cap over tree snapshots
        if self._tree is not None:
            self._tree.on_dense_drop = self._drop
        # ONE arena for the engine's lifetime; the step bodies write it in
        # place, and captured step graphs hold its addresses, so no leaf is
        # ever replaced.  Pages are never zeroed again: stale KV past a
        # slot's position is causally masked in the kernel.  Dense slots are
        # zeroed or snapshot-restored at admission — recurrent state has no
        # mask.  Each leaf has one scratch page or slot row past the pool
        # (index n_blocks, n_slots), which takes the writes the step bodies
        # drop (repro_torch.serve.decode); the pools never hand it out.  On
        # a grid of PE processes a PE's paged leaves hold its row's
        # ceil(n_blocks / q) pages, then the scratch page.
        self.arena = [{name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in entry.items()}
                      for entry in specs.arena_shapes(
                          specs.blocks_local(n_blocks) + 1,
                          (n_slots if specs.has_dense else 1) + 1)]
        self.slot_pool: Optional[DenseSlotPool] = DenseSlotPool(
            n_slots, slot_bytes=specs.dense_slot_bytes()) \
            if specs.has_dense else None
        self._dense_idx: List[int] = [
            i for i, e in enumerate(specs.entries)
            if isinstance(e, DenseSpec)]
        # prefix-token tuple -> host dense leaves at that position (FIFO cap:
        # the map must not grow with the number of distinct prompts served)
        self._prefix: "OrderedDict[Tuple[int, ...], HostLeaves]" = \
            OrderedDict()
        self.n_restores = 0            # snapshot copies INTO a slot
        # a grid: PE 0's log of commands for the other PEs (None off the
        # controller), a follower's snapshots by PE 0's number, and the
        # commands each PE has logged or applied, by kind
        self.commands: Optional[List[Tuple[int, int, int]]] = None
        self._held: Dict[int, HostLeaves] = {}
        self._next_sid = 0
        self.n_commands: Counter = Counter()

    # -- spec-derived facts -------------------------------------------------

    @property
    def needs_pages(self) -> bool:
        return self.specs.has_paged

    @property
    def has_dense(self) -> bool:
        return self.specs.has_dense

    @property
    def dense_slot_bytes(self) -> int:
        return self.specs.dense_slot_bytes()

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for entry in self.arena for t in entry.values())

    def snapshot_boundary(self, request) -> int:
        """The position admission can fast-forward a same-prompt sibling to:
        the last full-page boundary strictly before the final prompt token
        (that token must still be fed to produce the first logits).  Dense
        prefill launches are clamped to LAND on this boundary so the device
        state there is observable for snapshotting."""
        return (len(request.prompt) - 1) // self.stride * self.stride

    # -- scheduler hook face ------------------------------------------------

    def plan_resume(self, request, page_cap: int) -> int:
        """Resume position admission may grant ``request`` (pure read).

        ``page_cap`` is the furthest position adoptable KV pages cover
        (0 when the config has no paged layers).  Attention-only configs
        take the cap as-is; dense configs additionally require a dense
        snapshot at *exactly* the resume position — either the request's
        own preemption snapshot (page-free configs: replay-free restore at
        an arbitrary position) or a published prefix snapshot at a page
        boundary both state kinds can satisfy."""
        if not self.has_dense:
            return page_cap
        if request.dense_snapshot is not None and not self.needs_pages:
            return request.dense_snapshot[0]
        cap = self.snapshot_boundary(request)
        if self.needs_pages:
            cap = min(cap, page_cap)
        prompt = request.prompt
        if self._tree is not None:
            # hybrid: ONE radix walk, then the deepest matched node that
            # also carries a dense snapshot
            nodes = self._tree.match(prompt, cap // self.stride)
            for d in range(len(nodes), 0, -1):
                if nodes[d - 1].dense_snap is not None:
                    return d * self.stride
            return 0
        for b in range(cap, 0, -self.stride):
            if tuple(prompt[:b]) in self._prefix:
                return b
        return 0

    def can_admit(self, request) -> bool:
        return self.slot_pool is None or self.slot_pool.can_alloc()

    def commit_admit(self, request, resume: int) -> None:
        """Bind a dense slot and make its device rows consistent with
        ``resume``: a snapshot copy (physical, not ref-counted) when
        fast-forwarding, a zero-fill when starting from position 0."""
        if not self.has_dense:
            return
        request.dense_slot = self.slot_pool.alloc()
        snap = None
        if resume > 0:
            if request.dense_snapshot is not None \
                    and request.dense_snapshot[0] == resume:
                snap = request.dense_snapshot[1]
            elif self._tree is not None:
                node = self._tree.node_at(tuple(request.prompt[:resume]))
                snap = node.dense_snap if node is not None else None
            else:
                snap = self._prefix.get(tuple(request.prompt[:resume]))
            if snap is None:
                raise RuntimeError(
                    f"no dense snapshot at resume position {resume}")
        if snap is None:
            self._zero_slot(request.dense_slot)
        else:
            self._write_slot(request.dense_slot, snap)
            self.n_restores += 1
        if request.dense_snapshot is not None:
            self._drop(request.dense_snapshot[1])
            request.dense_snapshot = None

    def on_release(self, request, preempting: bool = False) -> None:
        """Retire/preempt: free the dense slot — after snapshotting it onto
        the request when the snapshot alone is a consistent resume point
        (page-free configs with progress; hybrid preemption drops state
        because its paged KV is released alongside).  A preempted request
        that ends before its readmission lets its snapshot go."""
        if not self.has_dense:
            return
        if not preempting and request.dense_snapshot is not None:
            self._drop(request.dense_snapshot[1])
            request.dense_snapshot = None
        if request.dense_slot is None:
            return
        if preempting and not self.needs_pages and request.num_cached > 0:
            request.dense_snapshot = (request.num_cached,
                                      self.read_slot(request.dense_slot))
        self.slot_pool.release(request.dense_slot)
        request.dense_slot = None

    # -- dense prefix snapshots (engine-side) -------------------------------

    def publish_dense_prefix(self, key: Tuple[int, ...], slot: int) -> None:
        key = tuple(key)
        if self._tree is not None:
            # ride the page tree: the snapshot attaches to the node owning
            # the prefix's last page.  No node means the page chain was
            # already evicted — a dense snapshot there could never be
            # adopted, skip it.
            node = self._tree.node_at(key)
            if node is None:
                return
            if node.dense_snap is None:
                self._snap_nodes.append(node)
            else:
                self._drop(node.dense_snap)
            node.dense_snap = self.read_slot(slot)
            while len(self._snap_nodes) > self.MAX_PREFIX_SNAPSHOTS:
                old = self._snap_nodes.popleft()
                if not old.detached:
                    self._drop(old.dense_snap)
                    old.dense_snap = None
            return
        if key in self._prefix:
            self._drop(self._prefix[key])
        self._prefix[key] = self.read_slot(slot)
        self._prefix.move_to_end(key)
        while len(self._prefix) > self.MAX_PREFIX_SNAPSHOTS:
            self._drop(self._prefix.popitem(last=False)[1])

    def has_dense_prefix(self, key: Tuple[int, ...]) -> bool:
        if self._tree is not None:
            node = self._tree.node_at(tuple(key))
            return node is not None and node.dense_snap is not None
        return tuple(key) in self._prefix

    # -- device slot ops (in place on the arena) ----------------------------

    def _dense_leaves(self) -> Dict[Tuple[int, str], torch.Tensor]:
        return {(i, name): leaf for i in self._dense_idx
                for name, leaf in self.arena[i].items()}

    def _log(self, op: int, a: int, b: int = 0) -> None:
        if self.commands is not None:
            self.commands.append((op, a, b))
            self.n_commands[COMMANDS[op]] += 1

    def _zero_slot(self, slot: int) -> None:
        for leaf in self._dense_leaves().values():
            leaf[:, slot].zero_()
        self._log(ZERO, slot)

    def _write_slot(self, slot: int, host_leaves: HostLeaves) -> None:
        for key, leaf in self._dense_leaves().items():
            leaf[:, slot].copy_(host_leaves[key])
        if self.commands is not None:
            self._log(WRITE, slot, host_leaves.sid)

    def read_slot(self, slot: int) -> HostLeaves:
        """Copy one dense slot's rows to the host (waits for in-flight
        work on the card).  On a grid controller the copy is a numbered
        :class:`Snapshot`, and the other PEs take theirs."""
        leaves = {key: leaf[:, slot].to("cpu", copy=True)
                  for key, leaf in self._dense_leaves().items()}
        if self.commands is None:
            return leaves
        snap = Snapshot(leaves)
        snap.sid = self._next_sid
        self._next_sid += 1
        self._log(READ, slot, snap.sid)
        return snap

    def _drop(self, snap: Optional[HostLeaves]) -> None:
        """PE 0 lets a snapshot go: the other PEs drop theirs."""
        if self.commands is not None and snap is not None:
            self._log(DROP, snap.sid)

    def apply(self, op: int, a: int, b: int) -> None:
        """A follower: carry out one command of PE 0's log on this PE's
        shard of the arena."""
        if op == ZERO:
            self._zero_slot(a)
        elif op == WRITE:
            self._write_slot(a, self._held[b])
        elif op == READ:
            self._held[b] = self.read_slot(a)
        elif op == DROP:
            del self._held[a]
        else:
            raise ValueError(f"unknown state command {op}")
        self.n_commands[COMMANDS[op]] += 1

    def snapshot_slots(self, slots: Sequence[int]) -> List[HostLeaves]:
        """Snapshot the dense rows of ``slots`` where the arena lives: one
        gather per dense leaf, in stream order on the engine's device, and
        no wait.  Entry i holds the same values :meth:`read_slot`
        ``(slots[i])`` would copy to the host, as views of the gathered
        leaves; :meth:`restore_slot` takes either."""
        idx = torch.tensor(list(slots), dtype=torch.long)
        rows = {key: leaf.index_select(1, idx.to(leaf.device))
                for key, leaf in self._dense_leaves().items()}
        return [{key: g[:, i] for key, g in rows.items()}
                for i in range(len(idx))]

    def restore_slot(self, slot: int, snapshot: HostLeaves) -> None:
        """Overwrite a live slot's rows with a snapshot taken by
        :meth:`read_slot` or :meth:`snapshot_slots` — the speculative
        rollback: a verify launch advanced the slot's recurrent state
        through all k+1 fed positions, and a partial acceptance rewinds it
        to the pre-launch snapshot (re-fed accepted tokens then re-advance
        it deterministically).  Unlike :meth:`commit_admit` the slot stays
        bound to its request."""
        self._write_slot(slot, snapshot)
        self.n_restores += 1


class NullStateHook:
    """Hook face for a scheduler with no state store: pages are the whole
    story, so every dense lifecycle event is a no-op and admission resumes
    exactly as far as adoptable pages reach."""

    needs_pages = True
    has_dense = False

    def plan_resume(self, request, page_cap: int) -> int:
        return page_cap

    def can_admit(self, request) -> bool:
        return True

    def commit_admit(self, request, resume: int) -> None:
        pass

    def on_release(self, request, preempting: bool = False) -> None:
        pass
