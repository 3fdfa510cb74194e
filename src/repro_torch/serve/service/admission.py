"""SLO-aware admission policies for the serving scheduler
(``repro.serve.service.admission``, copied).

The engine's :class:`~repro_torch.serve.engine.scheduler.Scheduler`
delegates the *ordering* half of admission to a pluggable
:class:`~repro_torch.serve.engine.scheduler.AdmissionPolicy` (the resource
accounting — pages, dense slots, buckets — stays in the scheduler).  The
engine package ships the default :class:`FifoAdmission`; this module adds
the two policies a latency-SLO service needs and a name registry:

============  ==============================================================
``fifo``      Arrival order, head-of-line blocking.  Maximizes fairness-by-
              age, but one long prompt at the head stalls everyone and the
              TTFT tail grows without bound under overload.
``deadline``  Earliest-TTFT-deadline-first (EDF), *shed on infeasible*: a
              waiting request whose first token can no longer arrive inside
              its deadline is rejected immediately (``finish_reason ==
              "shed"``) instead of burning capacity on an already-blown SLO.
              Requests without a deadline sort last (best-effort).  A
              capacity-blocked candidate is skipped, not head-of-line
              blocking — EDF only helps if a small urgent request can jump
              a large stalled one.
``fair_share``  Per-tenant round-robin at equal priority; strictly higher
              priority admits first and may *preempt* the lowest-priority
              running request (recompute-style eviction, the scheduler's
              existing mechanism) when capacity is exhausted.
============  ==============================================================

Policies are deliberately stateless apart from the fair-share rotation
cursor, and every decision is a pure function of (waiting, running, now) —
the unit tests drive them with a fake clock.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from repro_torch.serve.engine.request import Request
from repro_torch.serve.engine.scheduler import (AdmissionPolicy,
                                                FifoAdmission)


class DeadlineAdmission(AdmissionPolicy):
    """Earliest-TTFT-deadline-first with shed-on-infeasible.

    The feasibility bound on submit-to-first-token is, whenever the
    service has bound live telemetry (:meth:`bind`), a *measured* rolling
    estimate: the ``ServiceMetrics`` per-prompt-token prefill EMA scaled by
    the request's prompt length MINUS its radix-matched prefix tokens
    (cached pages are adopted, not prefilled, so a warm shared prefix makes
    an otherwise-infeasible request feasible again).  ``est_ttft_s`` stays
    as a static floor — and is the whole estimate before the first
    observation, or when the policy runs unbound (engine-only tests, page-
    free configs).  The default 0.0 sheds only already-blown deadlines.
    """

    name = "deadline"

    def __init__(self, est_ttft_s: float = 0.0):
        if est_ttft_s < 0:
            raise ValueError(f"est_ttft_s must be >= 0, got {est_ttft_s}")
        self.est_ttft_s = float(est_ttft_s)
        self._metrics = None
        self._pool = None

    def bind(self, engine, metrics) -> None:
        """Attach live telemetry: the service calls this once after
        installing the policy on its engine's scheduler."""
        self._metrics = metrics
        self._pool = engine.pool if engine.store.needs_pages else None

    def _est(self, r: Request) -> float:
        per_token = self._metrics.prefill_estimate() \
            if self._metrics is not None else None
        if per_token is None:
            return self.est_ttft_s
        matched = 0
        if self._pool is not None:
            n_pages, _ = self._pool.match_prefix(r.prompt)
            matched = n_pages * self._pool.block_pos_stride
        remaining = max(0, len(r.prompt) - matched)
        return max(self.est_ttft_s, per_token * remaining)

    def _deadline(self, r: Request) -> float:
        d = r.deadline_t
        return d if d is not None else float("inf")

    def shed(self, waiting: Sequence[Request], now: float) -> List[Request]:
        return [r for r in waiting
                if now + self._est(r) > self._deadline(r)]

    def select(self, waiting: Sequence[Request], running: Sequence[Request],
               now: float, blocked: Set[str]) -> Optional[Request]:
        cands = [r for r in waiting if r.request_id not in blocked]
        if not cands:
            return None
        # EDF; ties (e.g. the no-deadline tail) fall back to arrival order,
        # which list order already encodes
        return min(cands, key=self._deadline)


class FairShareAdmission(AdmissionPolicy):
    """Per-tenant round-robin with priority preemption.

    Selection order: highest ``Request.priority`` first; within a priority
    level, tenants take turns (a rotation cursor advances on every
    admission, so one chatty tenant cannot starve the rest) and each
    tenant's own requests stay FIFO.  When the selected request is
    capacity-blocked, the policy names the lowest-priority running request
    as a preemption victim — youngest among ties, matching the scheduler's
    own eviction order — provided it is STRICTLY lower priority than the
    candidate (equal-priority work is never churned).
    """

    name = "fair_share"

    def __init__(self):
        self._last_tenant: Optional[str] = None

    def select(self, waiting: Sequence[Request], running: Sequence[Request],
               now: float, blocked: Set[str]) -> Optional[Request]:
        cands = [r for r in waiting if r.request_id not in blocked]
        if not cands:
            return None
        top = max(r.priority for r in cands)
        # FIFO head per tenant at the top priority level
        heads: Dict[str, Request] = {}
        for r in cands:
            if r.priority == top and r.tenant not in heads:
                heads[r.tenant] = r
        tenants = sorted(heads)
        if self._last_tenant in tenants:
            i = tenants.index(self._last_tenant) + 1
            tenants = tenants[i:] + tenants[:i]
        return heads[tenants[0]]

    def victim(self, head: Request,
               running: Sequence[Request]) -> Optional[Request]:
        if not running:
            return None
        # youngest of the lowest-priority running requests (reversed() so
        # ties break the same way as the scheduler's LIFO eviction)
        victim = min(reversed(list(running)), key=lambda r: r.priority)
        return victim if victim.priority < head.priority else None

    def on_admit(self, request: Request) -> None:
        self._last_tenant = request.tenant


_POLICIES = {
    "fifo": FifoAdmission,
    "deadline": DeadlineAdmission,
    "fair_share": FairShareAdmission,
}


def make_policy(name: str, **kw) -> AdmissionPolicy:
    """Instantiate an admission policy by registry name (the string the
    service config and the CLIs accept)."""
    try:
        cls = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r}; "
            f"choose from {sorted(_POLICIES)}") from None
    return cls(**kw)
