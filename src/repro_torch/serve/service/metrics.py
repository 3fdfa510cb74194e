"""Service observability: per-request latency records + rolling aggregates
(``repro.serve.service.metrics``, copied).

The service layer is where latency *distributions* first exist — the
engine only ever sees one step at a time.  :class:`ServiceMetrics` collects
one :class:`RequestMetrics` per finished request (TTFT, queue wait,
inter-token gaps, finish reason) plus counters for the outcomes that never
reach the engine (backpressure rejections) or never produce a token
(sheds), and serves rolling p50/p99 aggregates over a bounded window so a
long-lived server's memory stays O(window), not O(requests served).

All mutation happens on the service's engine thread; ``snapshot()`` is
called from the asyncio side and takes the lock so a reader never sees a
half-updated window.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in [0, 100]); None on empty input.
    Nearest-rank (not interpolated) so a reported p99 is always a latency
    some real request actually experienced."""
    if not xs:
        return None
    s = sorted(xs)
    k = max(0, min(len(s) - 1, -(-int(p) * len(s) // 100) - 1))
    return s[k]


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    """One request's latency record, frozen at finish time."""

    request_id: str
    tenant: str
    priority: int
    # one of engine.request.FINISH_REASONS:
    # stop | length | cancelled | shed | error | drained
    finish_reason: str
    n_tokens: int
    ttft_s: Optional[float]             # None when no token was produced
    queue_wait_s: Optional[float]       # None when never admitted (shed)
    itl_s: List[float]                  # inter-token gaps (len n_tokens - 1)
    n_prompt_tokens: int = 0            # prompt length (prefill-cost scale)

    @property
    def itl_mean_s(self) -> Optional[float]:
        return sum(self.itl_s) / len(self.itl_s) if self.itl_s else None


class ServiceMetrics:
    """Rolling service-level aggregates + outcome counters."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.window = window
        self.n_submitted = 0
        self.n_completed = 0            # finish_reason stop | length
        self.n_cancelled = 0
        self.n_shed = 0                 # policy rejections (admission layer)
        self.n_rejected = 0             # backpressure rejections (never a
        #                                 Request: max_pending was hit)
        self.n_rate_limited = 0         # of the rejections, tenant
        #                                 token-bucket refusals
        self.n_error = 0                # resilience quarantines ("error")
        self.n_drained = 0              # graceful-drain checkpoints ("drained")
        self.n_tokens = 0
        # speculative decoding (stay 0 when the engine runs without it):
        # lifetime draft-token counters mirrored from EngineStats deltas
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        self.n_spec_rejected = 0
        # radix prefix cache (stay 0 with prefix_cache=False): lifetime
        # counters mirrored from EngineStats deltas by the service pump
        self.n_prefix_hits = 0
        self.n_prefix_tokens_reused = 0
        self.n_prefix_evictions = 0
        self.n_prompt_tokens_ingested = 0
        # per-tenant quota accounting: tenant -> {requests, tokens,
        # rate_limited} — requests/tokens at finish time, rate_limited at
        # the rejection (the tenant never reached the engine)
        self.tenant_usage: Dict[str, Dict[str, int]] = {}
        # replica supervision (stay 0 for the in-process service): worker
        # checkpoints, crash-triggered restarts, and per-restart recovery
        # time (detect -> respawned-and-restored) — the MTTR distribution
        self.n_checkpoints = 0
        self.n_worker_restarts = 0
        self._recovery: Deque[float] = deque(maxlen=window)
        # rolling per-token prefill time: EMA over finished requests of
        # (TTFT - queue wait) / prompt tokens.  The deadline admission
        # policy reads it (via prefill_estimate) to replace its static
        # est_ttft_s with a measured prefill-cost model.
        self._prefill_ema: Optional[float] = None
        self._prefill_alpha = 0.25
        self._ttft: Deque[float] = deque(maxlen=window)
        self._itl: Deque[float] = deque(maxlen=window)
        self._queue_wait: Deque[float] = deque(maxlen=window)
        self.records: Deque[RequestMetrics] = deque(maxlen=window)

    # -- engine-thread writers ----------------------------------------------

    def on_submitted(self) -> None:
        with self._lock:
            self.n_submitted += 1

    def on_rejected(self) -> None:
        with self._lock:
            self.n_rejected += 1

    def on_rate_limited(self, tenant: str) -> None:
        """A tenant token bucket refused a submit (counted as a rejection
        too: the request never became a Request)."""
        with self._lock:
            self.n_rejected += 1
            self.n_rate_limited += 1
            self._tenant(tenant)["rate_limited"] += 1

    def on_checkpoint(self, n_requests: int = 0) -> None:
        """The replica worker durably wrote one incremental checkpoint."""
        with self._lock:
            self.n_checkpoints += 1

    def on_restart(self, recovery_s: float) -> None:
        """One completed failover: crash detected -> fresh worker spawned,
        checkpoint restored, in-flight requests re-queued."""
        with self._lock:
            self.n_worker_restarts += 1
            self._recovery.append(recovery_s)

    def _tenant(self, tenant: str) -> Dict[str, int]:
        """(lock held) the tenant's quota-accounting row."""
        u = self.tenant_usage.get(tenant)
        if u is None:
            u = self.tenant_usage[tenant] = {
                "requests": 0, "tokens": 0, "rate_limited": 0}
        return u

    def on_speculation(self, proposed: int, accepted: int,
                       rejected: int) -> None:
        """Fold one pump's EngineStats delta of draft-token outcomes in."""
        with self._lock:
            self.n_spec_proposed += proposed
            self.n_spec_accepted += accepted
            self.n_spec_rejected += rejected

    def on_prefix(self, hits: int, tokens_reused: int, evictions: int,
                  ingested: int) -> None:
        """Fold one pump's EngineStats delta of prefix-cache outcomes in."""
        with self._lock:
            self.n_prefix_hits += hits
            self.n_prefix_tokens_reused += tokens_reused
            self.n_prefix_evictions += evictions
            self.n_prompt_tokens_ingested += ingested

    def prefill_estimate(self) -> Optional[float]:
        """Rolling seconds-per-prompt-token prefill estimate (None until a
        first-token latency has been observed)."""
        with self._lock:
            return self._prefill_ema

    def observe(self, rm: RequestMetrics) -> None:
        with self._lock:
            self.records.append(rm)
            u = self._tenant(rm.tenant)
            u["requests"] += 1
            u["tokens"] += rm.n_tokens
            if rm.ttft_s is not None and rm.n_prompt_tokens > 0:
                # queue wait is dead time, not prefill work: subtract it so
                # the estimate prices compute, and a loaded queue does not
                # inflate the shed threshold into a death spiral
                wait = rm.queue_wait_s or 0.0
                sample = max(0.0, rm.ttft_s - wait) / rm.n_prompt_tokens
                a = self._prefill_alpha
                self._prefill_ema = sample if self._prefill_ema is None \
                    else (1.0 - a) * self._prefill_ema + a * sample
            if rm.finish_reason in ("stop", "length"):
                self.n_completed += 1
            elif rm.finish_reason == "cancelled":
                self.n_cancelled += 1
            elif rm.finish_reason == "shed":
                self.n_shed += 1
            elif rm.finish_reason == "error":
                self.n_error += 1
            elif rm.finish_reason == "drained":
                self.n_drained += 1
            self.n_tokens += rm.n_tokens
            if rm.ttft_s is not None:
                self._ttft.append(rm.ttft_s)
            if rm.queue_wait_s is not None:
                self._queue_wait.append(rm.queue_wait_s)
            self._itl.extend(rm.itl_s)

    # -- readers -------------------------------------------------------------

    def snapshot(self) -> Dict:
        """One consistent view: counters + rolling p50/p99 latency
        aggregates (seconds).  The shape here is the shape the bench
        records and ``launch/serve.py --service`` print."""
        with self._lock:
            return {
                "submitted": self.n_submitted,
                "completed": self.n_completed,
                "cancelled": self.n_cancelled,
                "shed": self.n_shed,
                "rejected": self.n_rejected,
                "rate_limited": self.n_rate_limited,
                "error": self.n_error,
                "drained": self.n_drained,
                "tokens": self.n_tokens,
                "ttft_s": self._stats(self._ttft),
                "itl_s": self._stats(self._itl),
                "queue_wait_s": self._stats(self._queue_wait),
                "speculation": {
                    "proposed": self.n_spec_proposed,
                    "accepted": self.n_spec_accepted,
                    "rejected": self.n_spec_rejected,
                    "accept_rate": (
                        self.n_spec_accepted / self.n_spec_proposed
                        if self.n_spec_proposed else None),
                },
                "prefix_cache": {
                    "hits": self.n_prefix_hits,
                    "tokens_reused": self.n_prefix_tokens_reused,
                    "evictions": self.n_prefix_evictions,
                    "hit_rate": (
                        self.n_prefix_tokens_reused
                        / (self.n_prefix_tokens_reused
                           + self.n_prompt_tokens_ingested)
                        if self.n_prefix_tokens_reused
                        + self.n_prompt_tokens_ingested else None),
                },
                "prefill_s_per_token": self._prefill_ema,
                "tenants": {t: dict(u)
                            for t, u in sorted(self.tenant_usage.items())},
                "failover": {
                    "checkpoints": self.n_checkpoints,
                    "restarts": self.n_worker_restarts,
                    "recovery_s": self._stats(self._recovery),
                },
            }

    @staticmethod
    def _stats(xs: Sequence[float]) -> Dict[str, Optional[float]]:
        xs = list(xs)
        mean = sum(xs) / len(xs) if xs else None
        return {
            "n": len(xs),
            "mean": mean,
            "p50": percentile(xs, 50),
            "p99": percentile(xs, 99),
            "max": max(xs) if xs else None,
        }
