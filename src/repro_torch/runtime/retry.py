"""Shared bounded-retry semantics (``repro.runtime.retry``, copied).

The serving engine's step-retry path (``repro_torch.serve.resilience``)
runs under this one discipline — bounded attempts, linear or exponential
backoff, transient-only — and the training controller shares it,
instead of growing two subtly different loops.

A *transient* failure is one where re-running the same deterministic work
is expected to succeed (worker preemption, link flap, an injected chaos
fault); anything else propagates immediately.  Attempts beyond
``max_retries`` re-raise the last transient error, so callers always see
either a success or the real exception.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-attempt retry with linear or exponential backoff.

    ``max_retries`` counts RE-tries: 0 means one attempt total.  With the
    default ``growth=0.0`` the delay before attempt n (1, 2, ...) is the
    linear ramp ``backoff_s * n`` the training controller has always used;
    ``growth > 1.0`` switches to an exponential ramp
    ``backoff_s * growth**(n-1)`` capped at ``max_backoff_s`` — the
    replica supervisor's crash-loop containment schedule.  ``backoff_s ==
    0.0`` disables sleeping entirely (the serving engine's default — a
    drive-loop retry must not stall batch-mates).
    """

    max_retries: int = 3
    backoff_s: float = 0.01
    growth: float = 0.0             # 0.0 = linear ramp; >1.0 = exponential
    max_backoff_s: Optional[float] = None   # cap (exponential ramps only)

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.growth != 0.0 and self.growth < 1.0:
            raise ValueError(
                f"growth must be 0.0 (linear) or >= 1.0, got {self.growth}")
        if self.max_backoff_s is not None and self.max_backoff_s < 0:
            raise ValueError(
                f"max_backoff_s must be >= 0, got {self.max_backoff_s}")

    def delay_s(self, attempt: int) -> float:
        """Backoff before re-try ``attempt`` (1-based)."""
        if attempt < 1 or not self.backoff_s:
            return 0.0
        if self.growth:
            d = self.backoff_s * self.growth ** (attempt - 1)
            return d if self.max_backoff_s is None \
                else min(d, self.max_backoff_s)
        return self.backoff_s * attempt


def retry_with_backoff(
        fn: Callable[[], T], *,
        policy: RetryPolicy,
        transient: Tuple[Type[BaseException], ...],
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        sleep: Callable[[float], None] = time.sleep) -> T:
    """Run ``fn`` until it succeeds or retries are exhausted.

    ``on_retry(attempt, exc)`` fires before each re-try (attempt starts at
    1) — the hook where both clients count/log/rollback; raising from it
    aborts the loop.  ``sleep`` is injectable so tests never wall-wait.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except transient as e:                 # noqa: PERF203
            attempt += 1
            if attempt > policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            d = policy.delay_s(attempt)
            if d:
                sleep(d)
