"""Runtime helpers shared by the serving stack (``repro.runtime`` on one
device).  Only the retry policy is ported so far; the training
controller (``fault_tolerance``) comes with the training slice."""

from repro_torch.runtime.retry import RetryPolicy, retry_with_backoff

__all__ = ["RetryPolicy", "retry_with_backoff"]
