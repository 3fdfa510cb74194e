"""Continuous-batching scheduler: bucketed admission, LIFO preemption.

Policy (vLLM-style, adapted to the one-executable-per-bucket constraint):

  * Batch sizes are drawn from a fixed ascending tuple of powers of two
    (``prefill_bs{N}`` / ``decode_bs{N}`` in SHARK terms); the active bucket
    is the smallest one covering the running set, so a mixed workload never
    compiles per-request — at most one step executable per bucket.
  * Pluggable admission: a waiting request is admitted when a slot is free
    and the pool can back its whole current sequence plus one lookahead
    token.  WHICH waiting request is tried next — and whether a blocked
    candidate sheds, skips, or preempts running work — is delegated to an
    :class:`AdmissionPolicy` (default :class:`FifoAdmission`, the original
    head-of-line FIFO; the service slice adds SLO-aware
    ``deadline`` and ``fair_share`` policies).  Admission first adopts any
    published full-page prompt prefix from the pool (physically shared
    pages; the covered positions are skipped, not replayed), then
    allocates fresh pages for the remainder.
  * Before every step each running request's block table is grown to cover
    its next position; on pool exhaustion the *youngest* running request is
    preempted (blocks released, recompute on re-admission) until the oldest
    make progress — guaranteeing liveness while any single sequence fits.

Every lifecycle event additionally routes through a per-layer **state
hook** (``engine/state_store.py``), the StateSpec-driven side of the
contract: admission allocates a dense state slot alongside the pages and
may fast-forward to a snapshot-backed resume position
(``plan_resume``/``commit_admit``), retirement and preemption release the
slot (``on_release``, snapshotting first when that makes the restore
replay-free), and configs with no paged layers skip page accounting
entirely.  Attention-only engines plug in the no-op
:class:`~repro_torch.serve.engine.state_store.NullStateHook` and behave exactly
as before.

The scheduler is pure host logic over :mod:`request` and
:mod:`block_cache`; the engine owns devices (the hook is its proxy).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Set, Tuple

from repro_torch.serve.engine.block_cache import BlockPool, PoolExhausted, \
    SequenceBlocks
from repro_torch.serve.engine.request import Request, RequestState


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


class AdmissionPolicy:
    """The scheduler's admission hook: WHICH waiting request to try next,
    which to reject outright, and whether a blocked candidate may evict
    running work.  The scheduler keeps all resource accounting (pages,
    dense slots, buckets); the policy only orders and prunes.

    Contract per ``schedule()`` round:

      * :meth:`shed` runs once, first — requests it returns leave the
        waiting queue and finish as ``"shed"`` (never admitted).
      * :meth:`select` is called repeatedly with the ids the round already
        failed to admit (``blocked``); returning None ends admission.
        Head-of-line blocking vs. skip-ahead is therefore the policy's
        choice, not the scheduler's.
      * :meth:`victim` is consulted when the selection cannot be admitted
        for capacity: a returned running request is preempted (recompute
        on re-admission) and the selection is retried; None falls back to
        marking the selection blocked.
      * :meth:`on_admit` fires after a successful admission (round-robin
        cursors live here).
    """

    name = "base"

    def shed(self, waiting: Sequence[Request], now: float) -> List[Request]:
        return []

    def select(self, waiting: Sequence[Request], running: Sequence[Request],
               now: float, blocked: Set[str]) -> Optional[Request]:
        raise NotImplementedError

    def victim(self, head: Request,
               running: Sequence[Request]) -> Optional[Request]:
        return None

    def on_admit(self, request: Request) -> None:
        pass


class FifoAdmission(AdmissionPolicy):
    """The original policy: strict arrival order with head-of-line
    blocking — if the oldest waiting request does not fit, nothing younger
    may jump it (its pages free up soonest exactly because everything
    running is older)."""

    name = "fifo"

    def select(self, waiting, running, now, blocked):
        if waiting and waiting[0].request_id not in blocked:
            return waiting[0]
        return None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    buckets: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("need at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be ascending: {self.buckets}")
        bad = [b for b in self.buckets if not _is_pow2(b)]
        if bad:
            raise ValueError(f"buckets must be powers of two: {bad}")

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} exceeds max bucket {self.max_batch}")


@dataclasses.dataclass
class ScheduledStep:
    """One step's slot plan, consumed by the engine drive loop."""

    bucket: int
    slots: List[Optional[Request]]   # len == bucket; None = idle slot
    slot_map: List[int]              # new slot -> previous slot (-1 = none)
    admitted: List[Request]
    preempted: List[Request]
    # WAITING requests the admission policy rejected this round (already
    # FINISHED with reason "shed"); the service layer reports them
    shed: List[Request] = dataclasses.field(default_factory=list)
    # per-slot known-but-unfed token counts (0 = idle slot; 1 = steady-state
    # decode; >1 = prompt/replay still to ingest).  The engine picks the
    # chunked-prefill length L from these, so a launch may mix decode slots
    # (one position) with prefill slots (up to L positions) — admission
    # already guaranteed each slot's block table covers its whole sequence,
    # so any chunk within `remaining` is backed by allocated pages.
    remaining: List[int] = dataclasses.field(default_factory=list)

    @property
    def is_prefill(self) -> bool:
        """OpenCL-analogy label: a launch is a 'prefill enqueue' while any
        slot is still consuming prompt (or replayed) tokens — including the
        step that samples the first new token, as in SHARK's prefill
        invocation."""
        return any(r is not None and r.state == RequestState.PREFILL
                   for r in self.slots)

    @property
    def max_remaining(self) -> int:
        """Largest per-slot backlog: >1 iff some slot is mid-prefill."""
        return max(self.remaining, default=0)


class Scheduler:
    def __init__(self, pool: BlockPool,
                 config: Optional[SchedulerConfig] = None,
                 state=None, admission: Optional[AdmissionPolicy] = None,
                 clock=time.perf_counter):
        from repro_torch.serve.engine.state_store import NullStateHook
        self.pool = pool
        self.config = config or SchedulerConfig()
        self.state = state if state is not None else NullStateHook()
        self.admission = admission or FifoAdmission()
        self.clock = clock                   # injectable for policy tests
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []     # admission order (oldest first)
        self._bucket: Optional[int] = None
        self.n_preemptions = 0
        self.n_shed = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.state != RequestState.WAITING:
            raise ValueError(f"{request.request_id} is {request.state}, "
                             "only WAITING requests can be submitted")
        self.waiting.append(request)

    def cancel(self, request_id: str) -> bool:
        for i, r in enumerate(self.waiting):
            if r.request_id == request_id:
                del self.waiting[i]
                self.state.on_release(r)
                r.finish("cancelled")
                return True
        for r in self.running:
            if r.request_id == request_id:
                self._retire(r)
                r.finish("cancelled")
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- engine callbacks --------------------------------------------------

    def complete(self, request: Request, reason: str) -> None:
        """Engine reports a natural termination (EOS / length)."""
        self._retire(request)
        request.finish(reason)

    def drain_all(self, reason: str = "drained") -> List[Request]:
        """Finish EVERY live request (running then waiting) with ``reason``,
        releasing pages and dense slots through normal retirement — the
        terminal half of a graceful drain (the caller checkpoints the
        requests' progress first)."""
        out: List[Request] = []
        for r in list(self.running):
            self._retire(r)
            r.finish(reason)
            out.append(r)
        while self.waiting:
            r = self.waiting.popleft()
            self.state.on_release(r)
            r.finish(reason)
            out.append(r)
        return out

    def _retire(self, request: Request) -> None:
        self.running.remove(request)
        self.state.on_release(request, preempting=False)
        if request.blocks is not None:
            request.blocks.release_all()
            request.blocks = None
        request.slot = None

    def _evict(self, victim: Request) -> Request:
        """Preempt ``victim``: release its pages/slot (snapshot-first when
        that makes the restore replay-free) and push it to the FRONT of the
        waiting queue for earliest re-admission."""
        self.running.remove(victim)
        # snapshot-before-release: the hook may capture the victim's
        # dense leaves (replay-free restore) while num_cached is intact
        self.state.on_release(victim, preempting=True)
        if victim.blocks is not None:
            victim.blocks.release_all()
            victim.blocks = None
        victim.preempt()
        self.waiting.appendleft(victim)   # front: re-admit first
        self.n_preemptions += 1
        return victim

    def _preempt_one(self, keep: Request) -> Optional[Request]:
        """Evict the youngest running request other than ``keep``."""
        for victim in reversed(self.running):
            if victim is not keep:
                return self._evict(victim)
        return None

    def _peek_shared_prefix(self, request: Request) -> Tuple[int, List[bool]]:
        """(adoptable pages, per-page would-revive flags) for the longest
    cached token-block prefix — one radix walk, a pure read, so a blocked
    admission can be costed every schedule() without retain/release churn.
    Capped strictly before the final prompt token — that token must still
    be fed to produce the first logits."""
        return self.pool.match_prefix(request.prompt)

    def _shared_prefix_pages(self, request: Request, n: int) -> List[int]:
        """Retain (or revive) the first ``n`` peeked prefix pages."""
        return self.pool.adopt_prefix(request.prompt, n)

    # -- the policy --------------------------------------------------------

    def schedule(self) -> Optional[ScheduledStep]:
        preempted: List[Request] = []
        needs_pages = self.state.needs_pages

        # 1. guarantee every running request can write its next position,
        #    oldest first; evict youngest on exhaustion.  Page-free configs
        #    (pure dense state) have nothing to grow: their per-sequence
        #    footprint is O(1) by construction.
        for r in list(self.running):
            if not needs_pages or r not in self.running:   # evicted already
                continue
            while True:
                try:
                    r.blocks.ensure(r.num_cached + 1)
                    break
                except PoolExhausted:
                    victim = self._preempt_one(keep=r)
                    if victim is None:
                        raise RuntimeError(
                            f"KV pool ({self.pool.n_blocks} blocks of "
                            f"{self.pool.block_pos_stride}) cannot hold a "
                            f"single sequence of {r.num_cached + 1} tokens")
                    preempted.append(victim)

        # 2. Policy-ordered admission into free capacity.  The resume
        #    position comes from pages AND dense state together: published
        #    full-page prompt prefixes are adopted (shared physical pages,
        #    positions skipped outright) up to the furthest point the state
        #    hook can also back with a dense snapshot; only the remainder
        #    allocates fresh pages.  The AdmissionPolicy decides the try
        #    order, sheds infeasible requests, and may name a preemption
        #    victim when its selection is capacity-blocked.
        now = self.clock()
        shed: List[Request] = []
        for r in self.admission.shed(list(self.waiting), now):
            self.waiting.remove(r)
            r.finish("shed")
            self.n_shed += 1
            shed.append(r)
        admitted: List[Request] = []
        blocked: set = set()
        while self.waiting:
            head = self.admission.select(self.waiting, self.running,
                                         now, blocked)
            if head is None:
                break
            if len(self.running) >= self.config.max_batch:
                # batch full: only priority preemption (a policy naming a
                # strictly-lower-priority victim) can still admit
                victim = self.admission.victim(head, self.running)
                if victim is None or victim not in self.running:
                    break
                preempted.append(self._evict(victim))
            stride = self.pool.block_pos_stride
            if needs_pages:
                n_peek, revive_flags = self._peek_shared_prefix(head)
            else:
                n_peek, revive_flags = 0, []
            resume = self.state.plan_resume(head, n_peek * stride)
            n_shared = resume // stride if needs_pages else 0
            if needs_pages:
                needed = max(0, self.pool.blocks_for(
                    len(head.seq_tokens) + 1) - n_shared)
                # revived pages come off the free list too: cost them up front
                n_revive = sum(revive_flags[:n_shared])
            else:
                needed = n_revive = 0
            if not self.pool.can_alloc(needed + n_revive) \
                    or not self.state.can_admit(head):
                victim = self.admission.victim(head, self.running)
                if victim is not None and victim in self.running:
                    preempted.append(self._evict(victim))
                    continue      # retry head against the freed capacity
                if not self.running:
                    raise RuntimeError(
                        f"engine capacity too small to admit "
                        f"{head.request_id} ({needed} KV blocks needed of "
                        f"{self.pool.n_blocks}; dense slot "
                        f"available: {self.state.can_admit(head)})")
                blocked.add(head.request_id)
                continue          # the policy decides whether anyone skips it
            shared = self._shared_prefix_pages(head, n_shared)
            self.waiting.remove(head)
            head.blocks = SequenceBlocks(self.pool)
            head.blocks.adopt(shared)
            if needs_pages:
                head.blocks.ensure(len(head.seq_tokens) + 1)
            # bind the dense slot (zero-fill or physical snapshot copy)
            self.state.commit_admit(head, resume)
            if resume > 0:
                # the resumed positions' state is already resident (adopted
                # pages and/or restored dense leaves): never replayed
                head.num_cached = resume
            head.transition(RequestState.PREFILL)
            if not head.admit_t:
                head.admit_t = self.clock()   # queue wait ends at FIRST admit
            self.running.append(head)
            self.admission.on_admit(head)
            admitted.append(head)

        if not self.running:
            return None

        # 3. slot assignment within the chosen bucket: sticky where possible,
        #    compact on shrink (the engine migrates cache rows by slot_map)
        bucket = self.config.bucket_for(len(self.running))
        prev_slots = {r.request_id: r.slot for r in self.running}
        taken = set()
        for r in self.running:               # sticky slots first
            if r.slot is not None and r.slot < bucket and r.slot not in taken:
                taken.add(r.slot)
        free = iter(s for s in range(bucket) if s not in taken)
        slots: List[Optional[Request]] = [None] * bucket
        for r in self.running:
            if not (r.slot is not None and r.slot < bucket
                    and slots[r.slot] is None):
                r.slot = next(free)
            slots[r.slot] = r

        slot_map = [-1] * bucket
        for s, r in enumerate(slots):
            if r is None:
                continue
            prev = prev_slots.get(r.request_id)
            if r.num_cached > 0 and prev is not None:
                slot_map[s] = prev
        self._bucket = bucket
        remaining = [0 if r is None else r.remaining_known for r in slots]
        return ScheduledStep(bucket=bucket, slots=slots, slot_map=slot_map,
                             admitted=admitted, preempted=preempted,
                             shed=shed, remaining=remaining)
