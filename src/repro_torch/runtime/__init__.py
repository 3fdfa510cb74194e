"""Runtime helpers (``repro.runtime`` on one device): the bounded retry
policy shared by the serving engine's step guard and the training
controller, and the controller itself."""

from repro_torch.runtime.fault_tolerance import (FaultConfig, TrainController,
                                                 TransientWorkerFailure)
from repro_torch.runtime.retry import RetryPolicy, retry_with_backoff

__all__ = ["FaultConfig", "TrainController", "TransientWorkerFailure",
           "RetryPolicy", "retry_with_backoff"]
