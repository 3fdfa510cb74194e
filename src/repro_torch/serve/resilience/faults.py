"""Deterministic, seeded fault injection for the serving drive loop
(``repro.serve.resilience.faults``, copied: the same seed and the same
site queries draw the same schedule in either package).

Chaos engineering for the engine: a :class:`FaultInjector` carries one
seeded generator and a per-site firing probability; the engine's step
guard consults it at NAMED injection sites, so a fault schedule is a pure
function of (seed, site-query sequence) — two runs of the same workload
with the same injector seed inject byte-identical fault schedules, which
is what lets the chaos soak assert token parity for surviving requests.

=============  =========================================================
``launch``     The step enqueue raises BEFORE any device work (a failed
               ``clEnqueueNDRangeKernel`` in the paper's terms).  No
               state moved: retry is free.
``device``     The enqueue "succeeds" but the step fails at completion
               (a CUDA error surfacing at the step's synchronize).  KV
               pages were written (harmless — causally masked until
               committed) and dense slots advanced: the guard must
               restore pre-step snapshots before retrying.
``nan_logits`` A slot's sampled logits row turns non-finite (numerical
               poisoning).  Per-slot attributable: the guard rolls back
               only that slot, its batch-mates commit normally.
``pool``       Transient KV-pool exhaustion: the injector steals free
               pages for a few steps (returned automatically), forcing
               the scheduler through its preemption/blocked-admission
               paths under pressure.
``stall``      An artificial step stall (sleep) — what the service-layer
               watchdog exists to detect.
``process_kill``
               The replica worker process dies hard (``os._exit``, a
               simulated SIGKILL) mid-drive-loop.  Consulted per step by
               the supervisor's worker; the supervisor must detect the
               death and fail over from the last good checkpoint.
``checkpoint_corrupt``
               The checkpoint just written lands corrupted on disk
               (truncation / bit rot).  Consulted after each periodic
               checkpoint write; the restore path must fall back to the
               previous-good file.
=============  =========================================================

Every fired fault is recorded in :attr:`FaultInjector.events`;
``max_faults`` caps the total so a hostile rate schedule still terminates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

SITES = ("launch", "device", "nan_logits", "pool", "stall",
         "process_kill", "checkpoint_corrupt")


class FaultInjected(RuntimeError):
    """A fault fired at an injection site.  ``enqueued`` tells the guard
    whether device state may have advanced (the ``device`` site) and hence
    whether dense snapshots must be restored before a retry."""

    def __init__(self, site: str, enqueued: bool = False):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site
        self.enqueued = enqueued


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fired fault, for post-hoc schedule inspection."""

    index: int        # firing order (0-based)
    site: str
    detail: str = ""


class FaultInjector:
    """Seeded per-site fault source.

    ``rates`` maps site name -> firing probability per query (unnamed
    sites never fire).  Determinism contract: one internal generator,
    advanced once per query, so the schedule is reproducible from the
    seed for a fixed workload.  ``max_faults`` stops ALL injection after
    that many firings — the liveness valve for soak tests.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None, *,
                 stall_s: float = 0.002,
                 pool_steal_frac: float = 0.5,
                 pool_hold_steps: int = 2,
                 max_faults: Optional[int] = None):
        rates = dict(rates or {})
        bad = sorted(set(rates) - set(SITES))
        if bad:
            raise ValueError(
                f"unknown injection sites {bad}; choose from {list(SITES)}")
        for site, p in rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1]: {p}")
        if not 0.0 < pool_steal_frac <= 1.0:
            raise ValueError(
                f"pool_steal_frac must be in (0, 1]: {pool_steal_frac}")
        if pool_hold_steps < 1:
            raise ValueError(
                f"pool_hold_steps must be >= 1: {pool_hold_steps}")
        self.seed = seed
        self.rates = {s: float(rates.get(s, 0.0)) for s in SITES}
        self.stall_s = float(stall_s)
        self.pool_steal_frac = float(pool_steal_frac)
        self.pool_hold_steps = int(pool_hold_steps)
        self.max_faults = max_faults
        self.events: List[FaultEvent] = []
        self._rng = np.random.default_rng(seed)

    # -- the seeded source --------------------------------------------------

    @property
    def n_fired(self) -> int:
        return len(self.events)

    def _roll(self, site: str) -> bool:
        """One deterministic draw for ``site``.  The generator advances on
        every query with a nonzero rate (a zero-rate site costs nothing
        and does not perturb the schedule of the others)."""
        p = self.rates[site]
        if p <= 0.0:
            return False
        hit = bool(self._rng.random() < p)
        if hit and self.max_faults is not None \
                and self.n_fired >= self.max_faults:
            return False
        return hit

    def _record(self, site: str, detail: str = "") -> None:
        self.events.append(FaultEvent(self.n_fired, site, detail))

    # -- site queries (the engine-facing surface) ---------------------------

    def fire(self, site: str) -> None:
        """Raise :class:`FaultInjected` when ``site`` fires this query
        (the ``launch`` / ``device`` sites)."""
        if self._roll(site):
            self._record(site)
            raise FaultInjected(site, enqueued=(site == "device"))

    def corrupt_row(self, request_id: str) -> bool:
        """Should this slot's sampled logits row be poisoned (NaN)?"""
        if self._roll("nan_logits"):
            self._record("nan_logits", request_id)
            return True
        return False

    def stall(self) -> float:
        """Seconds to stall this step (0.0 = no stall this query)."""
        if self._roll("stall"):
            self._record("stall", f"{self.stall_s}s")
            return self.stall_s
        return 0.0

    def kill_process(self) -> bool:
        """Should the replica worker die hard (``os._exit``) this step?
        Queried by the supervisor's worker process; the record survives in
        THAT process's injector only, so the caller reports the kill
        through its event pipe before exiting."""
        if self._roll("process_kill"):
            self._record("process_kill")
            return True
        return False

    def corrupt_checkpoint(self) -> bool:
        """Should the checkpoint that was just written be corrupted on
        disk?  The supervisor worker truncates the current file when this
        fires, so a later restore exercises the previous-good fallback."""
        if self._roll("checkpoint_corrupt"):
            self._record("checkpoint_corrupt")
            return True
        return False

    def pool_steal(self, n_stealable: int) -> Tuple[int, int]:
        """(pages to steal, steps to hold them) — (0, 0) when the site
        does not fire or nothing is safely stealable.  ``n_stealable`` is
        the guard's upper bound: free pages minus the reserve that keeps
        the scheduler live (a single sequence must always fit)."""
        if n_stealable <= 0 or not self._roll("pool"):
            return 0, 0
        n = max(1, int(n_stealable * self.pool_steal_frac))
        n = min(n, n_stealable)
        self._record("pool", f"steal {n} pages for {self.pool_hold_steps} "
                             f"steps")
        return n, self.pool_hold_steps

    def counts(self) -> Dict[str, int]:
        """Fired-fault totals by site (for bench records / assertions)."""
        out = {s: 0 for s in SITES}
        for ev in self.events:
            out[ev.site] += 1
        return out
