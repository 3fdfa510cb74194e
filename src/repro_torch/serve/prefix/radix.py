"""Radix prefix cache: a trie of token blocks over published arena pages.

This is the structured host-side ownership layer the DSM companion paper
(arXiv:1704.08343) motivates for symmetric device memory, applied to the
paged KV arena: sharing is a *lookup*, never a copy.  The tree replaces
``BlockPool``'s flat ``Dict[token-tuple, page]`` prefix map, whose keys
stored the ENTIRE token prefix per page boundary — O(P^2/stride) key bytes
per prompt, and one full-tuple hash per boundary in the scheduler's
admission peek loop.

Structure (SGLang-style, fixed-arity edges):

  * every edge is labeled with exactly ONE ``block_pos_stride``-sized token
    block, so a node at depth d stands for the d*stride-token prefix spelled
    by its root path — and stores only its OWN block (O(stride) bytes);
  * every non-root node owns exactly one published arena page id + the
    page's generation at publish time.  The page holds the KV for the
    node's block of positions; the claim is recorded in a reverse index
    (``page -> node``) so the pool can route a page's free/revive
    transitions back to the tree in O(1);
  * prefix matching is ONE root-down walk: O(P) token comparisons total,
    independent of how many prompts were ever served.  Any shared
    token-block prefix across requests dedupes automatically — a shared
    system prompt is one chain of nodes, no matter how many distinct tails
    follow it.

Eviction (the cache OWNS it, ordered against the pool's free list):

  * a page whose refcount drops to zero while its node is cached does NOT
    go to the free list — the node becomes *evictable* and the KV stays
    revivable;
  * ``BlockPool.alloc`` takes uncached free pages first, and only when the
    free list is empty evicts the least-recently-touched evictable LEAF
    (``evict_one``) — so hot interior nodes (long shared prefixes) are
    recycled last, cold distinct tails first;
  * a node with a live page, or any live descendant, is never evicted:
    ``live_blockers`` counts live-claim strict descendants incrementally,
    so the pool's ``n_free`` can price exactly how many pages repeated
    leaf eviction can reclaim (``n_reclaimable``).

The cache reads the pool's refcount/generation arrays but never mutates
pool state directly: mutating operations return the pages that lost their
claims (``orphans``) and the pool moves them to its free list.  Generation
checks are kept on every walk even though the integrated flow cannot
produce a stale claim (``alloc`` only ever hands out claimless pages) —
they preserve the pre-tree revival contract defensively.

Pure host code: no device tensors are touched here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple


class RadixNode:
    """One cached token block: an edge label, a page claim, LRU metadata.

    ``dense_snap`` is the hybrid-model rider: the StateStore keys its
    published dense (SSM) boundary snapshots by tree node, so the dense
    side of a prefix dies exactly when its paged side is evicted.
    """

    __slots__ = ("block", "parent", "children", "page", "gen",
                 "last_access", "live_blockers", "dense_snap", "detached")

    def __init__(self, block: Tuple[int, ...], parent: Optional["RadixNode"],
                 page: int = -1, gen: int = -1):
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.page = page
        self.gen = gen
        self.last_access = 0
        # number of STRICT descendants whose claimed page is live (refs>0);
        # maintained incrementally on free<->live transitions so
        # reclaimability is O(evictable), not O(tree)
        self.live_blockers = 0
        self.dense_snap = None
        self.detached = False

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d, n = d + 1, n.parent
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"RadixNode(block={self.block}, page={self.page}, "
                f"gen={self.gen}, children={len(self.children)})")


class RadixPrefixCache:
    """The tree + its page-claim reverse index, bound to one BlockPool.

    The pool constructs the cache and owns the free list; the cache reads
    ``pool._refs`` / ``pool._gen`` for liveness and hands freed claims
    back as orphan lists.
    """

    def __init__(self, pool):
        self.pool = pool
        self.stride = pool.block_pos_stride
        self.root = RadixNode((), None)
        self._claims: Dict[int, RadixNode] = {}      # page id -> claimant
        self._evictable: Set[RadixNode] = set()      # claims with refs == 0
        self._tick = 0                               # LRU clock
        # told of each dense snapshot an eviction lets go (the StateStore
        # of a grid controller logs it for the other PEs)
        self.on_dense_drop = None

    # -- accounting ---------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        """Cached nodes == cached pages (every node owns exactly one)."""
        return len(self._claims)

    @property
    def n_reclaimable(self) -> int:
        """Pages obtainable by repeated leaf eviction RIGHT NOW: evictable
        nodes with no live descendant.  (Each such node's whole subtree is
        evictable, so peeling leaves reaches every one of them.)"""
        return sum(1 for n in self._evictable if n.live_blockers == 0)

    def key_tokens(self) -> int:
        """Total token-key bytes the tree retains, in tokens: one block per
        node — O(distinct blocks), never O(sum of prompt lengths squared)."""
        return sum(len(n.block) for n in self._claims.values())

    def claimant(self, page: int) -> Optional[RadixNode]:
        """The node whose claim on ``page`` is still generation-valid."""
        node = self._claims.get(page)
        if node is None or node.gen != self.pool._gen[page]:
            return None
        return node

    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.last_access = self._tick

    # -- walks --------------------------------------------------------------

    def match(self, tokens: Sequence[int], n_max: int,
              touch: bool = False) -> List[RadixNode]:
        """Longest cached block-prefix of ``tokens``: the chain of nodes
        for its first <= ``n_max`` blocks, one dict probe per block (the
        O(P) walk).  Stops at the first missing or generation-stale edge;
        pure read unless ``touch`` stamps the LRU clock."""
        s = self.stride
        refs_gen = self.pool._gen
        out: List[RadixNode] = []
        node = self.root
        for d in range(n_max):
            child = node.children.get(tuple(tokens[d * s:(d + 1) * s]))
            if child is None or refs_gen[child.page] != child.gen:
                break
            out.append(child)
            node = child
        if touch:
            for n in out:
                self._touch(n)
        return out

    def node_at(self, tokens: Sequence[int],
                touch: bool = False) -> Optional[RadixNode]:
        """Exact-key walk: the node spelling ALL of ``tokens`` (which must
        be a whole number of blocks), or None."""
        s = self.stride
        if not tokens or len(tokens) % s:
            return None
        d = len(tokens) // s
        chain = self.match(tokens, d, touch=touch)
        return chain[-1] if len(chain) == d else None

    # -- mutation -----------------------------------------------------------

    def publish(self, tokens: Sequence[int], page: int,
                gen: int) -> List[int]:
        """Insert/refresh the node for ``tokens`` (block-aligned) claiming
        ``page`` at generation ``gen``.  Returns orphaned pages — pages
        that lost their only claim while free — for the pool's free list.

        A missing strict ancestor makes the publish a no-op: a chain with a
        hole could never be adopted (adoption walks from the root), so we
        never cache it.  The engine publishes pages in ascending position
        order, which keeps ancestors present by construction."""
        s = self.stride
        d = len(tokens) // s
        block = tuple(tokens[(d - 1) * s:d * s])

        def walk_parent() -> Optional[RadixNode]:
            p = self.root
            for i in range(d - 1):
                p = p.children.get(tuple(tokens[i * s:(i + 1) * s]))
                if p is None:
                    return None
            return p

        parent = walk_parent()
        if parent is None:
            return []
        node = parent.children.get(block)
        if node is not None and node.page == page and node.gen == gen:
            self._touch(node)
            return []
        orphans: List[int] = []
        # a displaced claimant of `page` elsewhere in the tree cannot arise
        # from the engine flow (alloc only hands out claimless pages), but
        # an out-of-band publish could create one: prune it so the reverse
        # index stays a bijection.  The pruned subtree may have contained
        # our parent (or the node itself), so re-walk before inserting.
        prev = self._claims.get(page)
        if prev is not None and prev is not node:
            orphans.extend(self._prune(prev))
            parent = walk_parent()
            if parent is None:
                return orphans
            node = parent.children.get(block)
        if node is None:
            node = RadixNode(block, parent, page=page, gen=gen)
            parent.children[block] = node
            self._claims[page] = node
            # publish requires a live page (pool checks refs > 0): the new
            # node blocks every ancestor's eviction
            self._blockers(parent, +1)
        else:
            # re-point: the node's tokens are being re-prefilled through a
            # different physical page (concurrent same-prefix requests, or
            # a republish after the old page's adoption window closed).
            # Children stay — their own pages still hold their own KV, and
            # the chain's token spelling is unchanged.
            old = node.page
            if self._claims.get(old) is node:
                del self._claims[old]
                if node in self._evictable:
                    self._evictable.discard(node)
                    self._blockers(node.parent, +1)   # free -> live claim
                    if self.pool._gen[old] == node.gen \
                            and self.pool._refs[old] == 0:
                        orphans.append(old)
            node.page, node.gen = page, gen
            self._claims[page] = node
        self._touch(node)
        return orphans

    def on_freed(self, node: RadixNode) -> None:
        """Pool callback: the node's page refcount hit zero.  The page
        stays OFF the free list (cached, revivable); the node becomes
        evictable and stops blocking its ancestors."""
        self._evictable.add(node)
        self._blockers(node.parent, -1)

    def on_live(self, node: RadixNode) -> None:
        """Pool callback: a match revived the node's freed page (refs
        0 -> 1).  The inverse of :meth:`on_freed`."""
        self._evictable.discard(node)
        self._blockers(node.parent, +1)

    def evict_one(self) -> Optional[int]:
        """Evict the least-recently-touched evictable LEAF and return its
        page (None when nothing is evictable).  Leaf-first ordering means
        a long shared prefix dies tail-inward: hot interior nodes — the
        blocks most likely to be shared by the next request — survive
        longest.  Never evicts a node with children or a live page."""
        best: Optional[RadixNode] = None
        for n in self._evictable:
            if not n.children and (best is None
                                   or n.last_access < best.last_access):
                best = n
        if best is None:
            return None
        self._evictable.discard(best)
        del self._claims[best.page]
        best.parent.children.pop(best.block, None)
        best.detached = True
        self._drop_dense(best)
        return best.page

    # -- internals ----------------------------------------------------------

    def _drop_dense(self, node: RadixNode) -> None:
        """Let ``node``'s dense snapshot go, telling ``on_dense_drop``."""
        if node.dense_snap is not None and self.on_dense_drop is not None:
            self.on_dense_drop(node.dense_snap)
        node.dense_snap = None

    def _blockers(self, node: Optional[RadixNode], delta: int) -> None:
        """Add ``delta`` to the live-descendant count of ``node`` and every
        ancestor (O(depth); the root's count is maintained but unread)."""
        while node is not None:
            node.live_blockers += delta
            node = node.parent

    def _prune(self, node: RadixNode) -> List[int]:
        """Detach ``node``'s whole subtree (defensive path only).  Claims
        die with their nodes; valid claims on free pages are returned as
        orphans, live-claim removals unblock the surviving ancestors."""
        stack, nodes = [node], []
        while stack:
            n = stack.pop()
            nodes.append(n)
            stack.extend(n.children.values())
        orphans: List[int] = []
        live = 0
        for n in nodes:
            n.detached = True
            self._drop_dense(n)
            if self._claims.get(n.page) is n:
                del self._claims[n.page]
                if n in self._evictable:
                    self._evictable.discard(n)
                    if self.pool._gen[n.page] == n.gen \
                            and self.pool._refs[n.page] == 0:
                        orphans.append(n.page)
                else:
                    live += 1
            n.children.clear()
        if node.parent is not None:
            node.parent.children.pop(node.block, None)
            if live:
                self._blockers(node.parent, -live)
        return orphans
