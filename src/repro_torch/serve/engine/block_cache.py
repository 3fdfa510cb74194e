"""Paged KV block pool: ref-counted physical pages of the device arena.

Pool ids ARE physical arena indices: the device cache is one arena of
``(groups, n_blocks, block_pos_stride, kvh, hd)`` leaves
(``repro_torch.serve.state``) shared by every batch bucket, and the step
bodies consume per-slot block tables of these ids.  The pool is the
host-side ownership layer over that arena:

  * capacity   — ``n_blocks`` IS total KV memory; the scheduler admits and
                 preempts against it;
  * ref-counts — pages are shared by forked sequences and identical prompt
                 prefixes (the sharing is physical: one page, many tables),
                 and recycled through a free list on last release;
  * prefixes   — published full pages feed a :class:`RadixPrefixCache`
                 (``repro_torch.serve.prefix``): a trie keyed on stride-sized
                 token blocks, one node per resident page.  Matching any
                 shared token-block prefix is a single O(P) walk
                 (``match_prefix``), and adoption (``adopt_prefix``) hands
                 back retained pages.  A freed page whose node is cached
                 stays OFF the free list until the cache evicts it
                 (leaf-first LRU, after uncached free pages run out), so a
                 later request sharing the prefix revives the KV already in
                 device memory — nothing ever zeroes arena pages, and stale
                 contents past a sequence's position are causally masked
                 in-kernel.  Per-page generation counters still guard every
                 revival.  ``prefix_cache=False`` disables all of it: pure
                 free-list allocation, the parity baseline;
  * layout     — :func:`block_layout` derives the per-page device footprint
                 from the same StateSpec shapes the arena is allocated
                 from, so occupancy-in-bytes tracks the real arena.

Pure host code: no device tensors are touched here (a copy of
``repro.serve.engine.block_cache`` with identical behaviour).  On a grid of
PE processes the pool is the controller's (PE 0): page ids stay global,
and each step body routes page ``p`` to grid row ``p % q``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

from repro_torch.serve.prefix import RadixPrefixCache


class PoolExhausted(Exception):
    """Raised when an allocation cannot be satisfied (triggers preemption)."""


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Device footprint of one KV page (``block_pos_stride`` positions of one
    sequence, across all layer groups and the PEs that store it), and where
    a page lives on a grid of ``q`` rows."""

    block_pos_stride: int
    bytes_per_block: int
    q: int = 1                    # grid rows: page p on row p % q, at p // q


def block_layout(specs, *, block_pos_stride: int, plan=None) -> BlockLayout:
    """Price one page from the engine's StateSpec list
    (:class:`repro_torch.serve.state.ModelStateSpecs`), the single source
    of truth for the arena's shapes.  Dense-state layers contribute zero
    page bytes: their residency is priced per slot
    (:attr:`DenseSlotPool.slot_bytes`).  With a grid ``plan`` the specs
    must be that grid's; a page then spans its row's r PEs."""
    q = 1 if plan is None else plan.grid_q
    if specs.q != q:
        raise ValueError(f"state specs of {specs.q} grid rows priced for a "
                         f"plan of {q}")
    return BlockLayout(block_pos_stride=block_pos_stride,
                       bytes_per_block=specs.page_bytes(), q=q)


class BlockPool:
    """Fixed pool of physical KV pages: ref-counting, free-list recycling,
    radix-tree prefix caching with generation-checked revival."""

    def __init__(self, n_blocks: int, block_pos_stride: int,
                 layout: Optional[BlockLayout] = None,
                 prefix_cache: bool = True):
        if n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        if block_pos_stride < 1:
            raise ValueError("block_pos_stride must be >= 1")
        self.n_blocks = n_blocks
        self.block_pos_stride = block_pos_stride
        self.layout = layout
        # uncached free pages only: a freed page whose prefix node is still
        # cached lives in the tree's evictable set instead, and re-enters
        # this deque only as an eviction/orphan.  alloc pops the right,
        # release appends the LEFT (O(1)), so recently-freed uncached pages
        # are recycled last
        self._free: Deque[int] = deque(range(n_blocks - 1, -1, -1))
        self._refs: List[int] = [0] * n_blocks
        self._gen: List[int] = [0] * n_blocks
        self.cache: Optional[RadixPrefixCache] = \
            RadixPrefixCache(self) if prefix_cache else None
        # monotone counters; the engine folds deltas into EngineStats
        self.n_prefix_hits = 0
        self.n_prefix_tokens_reused = 0
        self.n_prefix_evictions = 0

    # -- capacity ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        """Pages an allocation burst can obtain: the uncached free list
        plus every cached page reclaimable by repeated leaf eviction."""
        n = len(self._free)
        if self.cache is not None:
            n += self.cache.n_reclaimable
        return n

    @property
    def n_used(self) -> int:
        """Pages referenced by live sequences (cached-but-free pages are
        reclaimable, so they count as free capacity, not residency)."""
        return self.n_blocks - self.n_free

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-n_tokens // self.block_pos_stride) if n_tokens > 0 else 0

    def can_alloc(self, n: int) -> bool:
        return self.n_free >= n

    # -- alloc / free ------------------------------------------------------

    def alloc(self) -> int:
        if self._free:
            bid = self._free.pop()
        else:
            # free list dry: evict the LRU cached leaf.  This is the
            # ordering contract — uncached pages are always recycled before
            # any cached prefix KV is sacrificed, and within the cache cold
            # leaves go before hot interior (shared) nodes.
            bid = self.cache.evict_one() if self.cache is not None else None
            if bid is None:
                raise PoolExhausted(
                    f"all {self.n_blocks} KV blocks in use")
            self.n_prefix_evictions += 1
        self._refs[bid] = 1
        self._gen[bid] += 1     # any KV previously resident here is dead
        return bid

    def retain(self, bid: int) -> int:
        if self._refs[bid] <= 0:
            raise ValueError(f"retain of free block {bid}")
        self._refs[bid] += 1
        return bid

    def release(self, bid: int) -> None:
        if self._refs[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            node = self.cache.claimant(bid) if self.cache is not None \
                else None
            if node is not None:
                # prefix-cached: keep the page out of the free list so its
                # KV stays revivable; the tree now owns its recycling order
                self.cache.on_freed(node)
            else:
                self._free.appendleft(bid)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    # -- prefix sharing ----------------------------------------------------
    #
    # Published keys are the full token prefixes a page completes, always a
    # whole number of stride-sized blocks; the tree stores one block per
    # node, so retention is O(distinct blocks) regardless of how many
    # prompts were ever served.  An adoption hands back pages with fresh
    # references: the adopting sequence points its block table at the SAME
    # physical pages, so any requests sharing a token-block prefix (and
    # `fork()` siblings) share device memory, not just accounting.

    def match_prefix(self, prompt: Sequence[int],
                     n_max: Optional[int] = None) -> Tuple[int, List[bool]]:
        """Longest cached block-prefix of ``prompt``: one O(P) root-down
        walk.  Returns ``(n_pages, revive_flags)`` where ``revive_flags[i]``
        says adopting page i would revive a freed page.  Pure read — the
        admission peek.  ``n_max`` caps the depth; the default stops short
        of the final token so an admitted sequence always has at least one
        position to prefill."""
        if self.cache is None:
            return 0, []
        if n_max is None:
            n_max = (len(prompt) - 1) // self.block_pos_stride
        nodes = self.cache.match(prompt, n_max)
        return len(nodes), [self._refs[n.page] == 0 for n in nodes]

    def adopt_prefix(self, prompt: Sequence[int], n: int) -> List[int]:
        """Retain the first ``n`` matched prefix pages of ``prompt`` and
        return their ids (the admission commit for a peeked match)."""
        if n <= 0 or self.cache is None:
            return []
        nodes = self.cache.match(prompt, n, touch=True)
        if len(nodes) < n:
            # peek and adopt run back-to-back in one admission step with no
            # allocation in between, so the match cannot shrink
            raise RuntimeError(
                f"prefix match shrank between peek and adopt: "
                f"wanted {n}, found {len(nodes)}")
        return [self._adopt_node(node) for node in nodes]

    def _adopt_node(self, node) -> int:
        bid = node.page
        if self._refs[bid] > 0:
            self._refs[bid] += 1
        else:
            # freed but still cached: revive in O(1) — evictable pages are
            # not on the free list, so no O(n) free-list surgery
            self._refs[bid] = 1
            self.cache.on_live(node)
        self.n_prefix_hits += 1
        self.n_prefix_tokens_reused += self.block_pos_stride
        return bid

    def publish_prefix(self, key: Tuple[int, ...], bid: int) -> None:
        """Cache ``bid`` as the page completing token prefix ``key`` (must
        be a whole number of blocks).  Pages orphaned by the insert (a free
        page losing its only claim) drop back to the free list."""
        if self._refs[bid] <= 0:
            raise ValueError(f"publishing free block {bid}")
        if self.cache is None:
            return
        key = tuple(key)
        if not key or len(key) % self.block_pos_stride:
            raise ValueError(
                f"prefix key must be a whole number of "
                f"{self.block_pos_stride}-token blocks, got {len(key)}")
        for orphan in self.cache.publish(key, bid, self._gen[bid]):
            self._free.appendleft(orphan)

    def peek_prefix(self, key: Tuple[int, ...]) -> Optional[bool]:
        """Would :meth:`lookup_prefix` hit?  Returns None on a miss, else
        whether the hit would REVIVE a freed page.  Pure read: no refcount,
        free-list or tree mutation."""
        if self.cache is None:
            return None
        node = self.cache.node_at(tuple(key))
        if node is None:
            return None
        return self._refs[node.page] == 0

    def lookup_prefix(self, key: Tuple[int, ...]) -> Optional[int]:
        """Exact-key adoption of one page (single-page form of
        :meth:`adopt_prefix`): a hit retains and returns the page."""
        if self.cache is None:
            return None
        node = self.cache.node_at(tuple(key), touch=True)
        if node is None:
            return None
        return self._adopt_node(node)


class DenseSlotPool:
    """Fixed pool of dense per-sequence state slots (``DenseSpec`` layers).

    Dense state is O(1) per sequence and — unlike KV pages — NOT
    ref-countable: a slot belongs to exactly one request at a time, and
    "sharing" dense state means physically copying a snapshot into a fresh
    slot (``engine/state_store.py``).  The pool is pure host bookkeeping
    over the slot rows of the device state arena; ``slot_bytes`` prices one
    slot's device residency (``ModelStateSpecs.dense_slot_bytes``).
    """

    def __init__(self, n_slots: int, slot_bytes: int = 0):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self._free: Deque[int] = deque(range(n_slots - 1, -1, -1))
        self._used: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def can_alloc(self) -> bool:
        return bool(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"all {self.n_slots} dense slots in use")
        sid = self._free.pop()
        self._used.add(sid)
        return sid

    def release(self, sid: int) -> None:
        if sid not in self._used:
            raise ValueError(f"release of free dense slot {sid}")
        self._used.discard(sid)
        self._free.append(sid)


class SequenceBlocks:
    """The block table of one sequence: an append-only run of pages."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.ids: List[int] = []

    @property
    def capacity(self) -> int:
        """Cache positions currently backed by allocated pages."""
        return len(self.ids) * self.pool.block_pos_stride

    def ensure(self, n_tokens: int) -> None:
        """Grow the table to cover ``n_tokens`` positions (atomic: either all
        needed pages are allocated or none, so a failed grow can be retried
        after preemption)."""
        need = self.pool.blocks_for(n_tokens) - len(self.ids)
        if need <= 0:
            return
        if not self.pool.can_alloc(need):
            raise PoolExhausted(
                f"need {need} blocks, {self.pool.n_free} free")
        self.ids.extend(self.pool.alloc() for _ in range(need))

    def adopt(self, ids: List[int]) -> None:
        """Seed an empty table with already-retained shared prefix pages."""
        if self.ids:
            raise ValueError("adopt() requires an empty table")
        self.ids = list(ids)

    def release_all(self) -> None:
        for bid in reversed(self.ids):
            self.pool.release(bid)
        self.ids = []

    def rewind(self, n_tokens: int) -> int:
        """Shrink the table to cover exactly ``n_tokens`` positions,
        releasing the tail pages (newest first — the speculative-decoding
        rollback).  Returns the number of pages released.  The rewound
        pages' KV is NOT erased on device: a page that comes back through
        ``ensure`` is freshly allocated (possibly a different physical id,
        always a new generation), and any stale prefix entries for the
        released pages die at reallocation via the generation counters —
        stale KV inside still-held pages past ``n_tokens`` is causally
        masked in-kernel, so attention rollback is pure host bookkeeping."""
        keep = self.pool.blocks_for(n_tokens)
        freed = 0
        while len(self.ids) > keep:
            self.pool.release(self.ids.pop())
            freed += 1
        return freed

    def fork(self) -> "SequenceBlocks":
        """Share this table with a sibling sequence (ref-count bump)."""
        child = SequenceBlocks(self.pool)
        child.ids = [self.pool.retain(bid) for bid in self.ids]
        return child
