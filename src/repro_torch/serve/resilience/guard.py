"""Step-level retry with rollback + poisoned-request quarantine
(``repro.serve.resilience.guard`` on one device).

The :class:`StepGuard` wraps the engine's drive-loop launch the way the
training controller wraps a training step — the shared
:func:`repro_torch.runtime.retry.retry_with_backoff` helper, bounded-
attempt semantics — but a serving step is a BATCH: one failed launch must
not poison the cohabiting slots.  The rollback contract mirrors
speculative decoding's, split along the per-layer StateSpec kinds:

  * **paged KV** is free to roll back: the failed launch may have written
    K/V pages, but committed positions (``num_cached``) never advanced,
    so the stale entries are causally masked and the retry rewrites them
    byte-identically.  No device work needed.
  * **dense (SSM) state** advanced through every fed position
    unconditionally, so the guard snapshots each active slot BEFORE the
    launch and restores on failure (``restore_slot``, in place in the
    arena the step graphs are bound to) — the machinery the speculative
    decoder uses for rejected drafts.  The JAX guard copies each slot to
    the host (``read_slot``); here the snapshot stays on the card
    (``StateStore.snapshot_slots``: one gather per dense leaf, in stream
    order before the launch, with no wait), with the same values.

Failure attribution:

  * a **launch/device fault** is batch-wide and transient: retry the
    whole step up to ``retry.max_retries`` times (state restored between
    attempts).  When retries exhaust, every cohabiting request is charged
    one failure — no single slot can be blamed — and the step yields
    without progress; requests crossing ``max_request_failures``
    consecutive charges are quarantined.
  * a **non-finite logits row** is per-slot attributable: only that slot
    is rolled back and charged (its batch-mates commit normally); it
    re-feeds the same token next step, and quarantines once it crosses
    the threshold.  A committed step resets a request's charge count —
    "repeatedly" means consecutively.

Quarantine finishes the request with ``finish_reason="error"`` through
the scheduler's normal retirement path, so its pages and dense slot
return to their pools exactly like any natural completion.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.retry import RetryPolicy, retry_with_backoff
from repro_torch.serve.resilience.faults import FaultInjected


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Engine-side resilience knobs (``EngineConfig.resilience``)."""

    # bounded whole-step retry on launch/device faults; backoff defaults
    # to 0 — a drive-loop retry must not stall the other slots' latency
    retry: RetryPolicy = RetryPolicy(max_retries=2, backoff_s=0.0)
    # consecutive failed/poisoned steps a request survives before it is
    # quarantined (finish_reason="error"); the count resets on any
    # committed step
    max_request_failures: int = 2

    def __post_init__(self):
        if self.max_request_failures < 0:
            raise ValueError(f"max_request_failures must be >= 0: "
                             f"{self.max_request_failures}")


class StepGuard:
    """Per-engine resilience guard (constructed by ``ServingEngine``
    when ``EngineConfig.fault_injector`` or ``.resilience`` is set)."""

    def __init__(self, engine, cfg: ResilienceConfig):
        self.eng = engine
        self.cfg = cfg
        # pool-pressure fault state: pages the injector is holding hostage
        self._stolen: List[int] = []
        self._steal_release_tick = 0
        self._ticks = 0

    # -- transient pool exhaustion ------------------------------------------

    def pre_schedule(self) -> None:
        """Apply/expire pool-pressure faults BEFORE the scheduler plans:
        stolen pages shrink the free list (forcing preemption / blocked
        admission) and return automatically after the hold."""
        eng = self.eng
        self._ticks += 1
        if self._stolen and self._ticks >= self._steal_release_tick:
            for bid in self._stolen:
                eng.pool.release(bid)
            self._stolen = []
        inj = eng.engine_cfg.fault_injector
        if inj is None or self._stolen or not eng.store.needs_pages:
            return
        n, hold = inj.pool_steal(self._stealable())
        if n:
            self._stolen = [eng.pool.alloc() for _ in range(n)]
            self._steal_release_tick = self._ticks + hold
            eng.stats.fault_pool_steals += 1

    def release_stolen(self) -> None:
        """Return any held pool-fault pages immediately (the engine calls
        this when it goes idle — an injector must never leak pages past
        the workload that suffered it)."""
        for bid in self._stolen:
            self.eng.pool.release(bid)
        self._stolen = []

    def _stealable(self) -> int:
        """Upper bound on pages the injector may steal without breaking
        the scheduler's liveness guarantee: after the steal, the largest
        admitted-or-waiting sequence (plus its one-token lookahead) must
        still fit the non-stolen pool even if everything else is
        preempted."""
        eng = self.eng
        pool = eng.pool
        reserve = 0
        s_max = eng.engine_cfg.s_max
        for r in (*eng.scheduler.running, *eng.scheduler.waiting):
            worst = min(len(r.prompt) + r.sampling.max_tokens, s_max)
            reserve = max(reserve, pool.blocks_for(worst) + 1)
        return min(pool.n_free, pool.n_blocks - reserve)

    # -- the guarded step ----------------------------------------------------

    def step(self, sd, chunk) -> bool:
        """Run one scheduled step under retry/rollback/quarantine.
        Always returns True: the schedule was consumed, even when a
        retry-exhausted step made no token progress."""
        eng, cfg = self.eng, self.cfg
        stats = eng.stats
        inj = eng.engine_cfg.fault_injector
        active: List[Tuple[int, object]] = [
            (s, r) for s, r in enumerate(sd.slots) if r is not None]

        # pre-step dense snapshots: the launch advances recurrent state
        # through every fed position whether or not the step commits
        snaps: Dict[int, dict] = {}
        if eng.store.has_dense:
            snaps = dict(zip([s for s, _ in active], eng.store.snapshot_slots(
                [r.dense_slot for _, r in active])))

        if inj is not None:
            d = inj.stall()
            if d:
                stats.fault_stalls += 1
                time.sleep(d)

        def _rollback(attempt: int, e: BaseException) -> None:
            stats.fault_launch_failures += 1
            stats.fault_retries += 1
            self._restore_all(snaps, sd, e)

        try:
            rows, fed = retry_with_backoff(
                lambda: eng._launch(sd, chunk), policy=cfg.retry,
                transient=(FaultInjected,), on_retry=_rollback)
        except FaultInjected as e:
            # retries exhausted: restore, charge every cohabiting request
            # (a batch-wide fault has no single culprit), quarantine the
            # repeat offenders, and yield the step without progress
            stats.fault_launch_failures += 1
            self._restore_all(snaps, sd, e)
            for s, r in active:
                r.fault_failures += 1
                if r.fault_failures > cfg.max_request_failures:
                    self._quarantine(r)
            return True

        # clFinish BEFORE any restore: a restore must follow the launch
        # that advanced the slot
        eng.queue.finish()

        # non-finite detection on the rows that would be sampled this
        # step (mid-prefill rows are never consumed); injected NaN and a
        # genuinely poisoned model row take the same path.  ``rows`` views
        # the step's host buffer, which its next run overwrites, so a
        # poisoned row never outlives the step.
        skip = set()
        for s, r in active:
            if r.num_cached + fed[s] != len(r.seq_tokens):
                continue                     # no sample from this slot
            if inj is not None and inj.corrupt_row(r.request_id):
                rows[s] = np.nan                 # physically poison the row
            if not np.isfinite(rows[s]).all():
                stats.fault_nonfinite += 1
                r.fault_failures += 1
                skip.add(s)
        for s in sorted(skip):
            r = sd.slots[s]
            if r.fault_failures > cfg.max_request_failures:
                self._quarantine(r)          # releases the slot wholesale
            elif s in snaps:
                # per-slot rollback: restore the pre-step recurrent state;
                # num_cached never advanced, so the next step re-feeds the
                # same token (paged KV is already causally masked)
                eng.store.restore_slot(r.dense_slot, snaps[s])

        eng._commit(sd, rows, fed, skip=skip)
        return True

    # -- the guarded speculative step ---------------------------------------

    def spec_step(self, sd) -> Optional[bool]:
        """Run one SPECULATIVE step (draft + verify launch + commit) under
        the same retry/rollback/quarantine discipline as :meth:`step`.

        Returns None when no slot yields a usable draft this round (the
        caller falls back to the guarded plain launch), True otherwise —
        including a retry-exhausted round that made no progress but rolled
        its draft tail back cleanly: dense slots restored to their
        pre-launch snapshots, draft-ensured pages freed, and the drafter's
        fed record truncated to the committed sequence."""
        eng, cfg = self.eng, self.cfg
        stats = eng.stats
        spec = eng.spec
        inj = eng.engine_cfg.fault_injector
        rnd = spec.prepare(sd)
        if rnd is None:
            return None

        if inj is not None:
            d = inj.stall()
            if d:
                stats.fault_stalls += 1
                time.sleep(d)

        def _rollback(attempt: int, e: BaseException) -> None:
            stats.fault_launch_failures += 1
            stats.fault_retries += 1
            self._spec_restore(rnd, e)

        try:
            rows = retry_with_backoff(
                lambda: spec.launch(rnd), policy=cfg.retry,
                transient=(FaultInjected,), on_retry=_rollback)
        except FaultInjected as e:
            # retries exhausted: roll back the whole round (verify pages
            # AND drafter state), charge every cohabiting request, and
            # quarantine the repeat offenders — the batch-wide attribution
            # rule of :meth:`step`
            stats.fault_launch_failures += 1
            self._spec_restore(rnd, e)
            spec.rollback_in_flight()
            for s, r in enumerate(sd.slots):
                if r is None:
                    continue
                r.fault_failures += 1
                if r.fault_failures > cfg.max_request_failures:
                    self._quarantine(r)
            return True

        # clFinish BEFORE any restore (as in step())
        eng.queue.finish()

        # non-finite verify rows are per-slot attributable: that slot
        # commits nothing this round — its snapshot is restored and its
        # draft tail rolled back by commit(skip=...) — while batch-mates
        # accept/reject normally
        skip = set()
        for s, r in enumerate(sd.slots):
            if r is None or not rnd.fed[s]:
                continue
            consumes = r.samples_this_step or s in rnd.proposals
            if not consumes:
                continue
            if inj is not None and inj.corrupt_row(r.request_id):
                rows[s] = np.nan                 # physically poison the row
            if not np.isfinite(rows[s, :rnd.fed[s]]).all():
                stats.fault_nonfinite += 1
                r.fault_failures += 1
                skip.add(s)
        spec.commit(rnd, rows, skip=skip)
        for s in sorted(skip):
            r = sd.slots[s]
            if not r.is_finished \
                    and r.fault_failures > cfg.max_request_failures:
                self._quarantine(r)          # releases the slot wholesale
        return True

    def _spec_restore(self, rnd, e) -> None:
        """Undo a failed verify attempt between retries: drain the failed
        launch, restore every snapshotted dense slot.  Pages and host
        bookkeeping never advanced; the drafter is NOT rolled back here —
        the retry re-runs the identical launch, so its proposals stand."""
        if not getattr(e, "enqueued", True):
            return
        eng = self.eng
        eng.queue.finish()
        for s, leaves in rnd.snaps.items():
            r = rnd.sd.slots[s]
            if r is not None and r.dense_slot is not None:
                eng.store.restore_slot(r.dense_slot, leaves)

    # -- rollback / quarantine ----------------------------------------------

    def _restore_all(self, snaps: Dict[int, dict], sd, e) -> None:
        """Undo a failed attempt.  Host bookkeeping never advanced (commit
        happens strictly after a successful launch); device KV writes are
        causally masked; dense slots need a physical restore — but only
        when the failed attempt actually enqueued (``device`` site)."""
        if not getattr(e, "enqueued", True):
            return
        eng = self.eng
        # drain the failed launch UNCONDITIONALLY (even with no dense
        # slots to restore), so the queue holds no stale pending entry
        # when the retry enqueues
        eng.queue.finish()
        for s, leaves in snaps.items():
            r = sd.slots[s]
            if r is not None and r.dense_slot is not None:
                eng.store.restore_slot(r.dense_slot, leaves)

    def _quarantine(self, r) -> None:
        """Finish ``r`` as ``"error"`` through normal retirement: pages
        and dense slot return to their pools, batch-mates are untouched,
        and the scheduler re-plans without it next step."""
        eng = self.eng
        eng.scheduler.complete(r, "error")
        eng._rngs.pop(r.request_id, None)
        if eng.spec is not None:
            eng.spec.release(r.request_id)
        eng.stats.fault_quarantined += 1
