"""Chaos-hardening for the serving stack (``repro.serve.resilience`` on
one device).

Three cooperating pieces, each usable alone:

  * :mod:`~repro_torch.serve.resilience.faults` — the deterministic,
    seeded :class:`FaultInjector` with named injection sites (``launch``,
    ``device``, ``nan_logits``, ``pool``, ``stall``).
  * :mod:`~repro_torch.serve.resilience.guard` — the engine's
    :class:`StepGuard`: bounded step retry with paged/dense rollback
    (dense snapshots kept on the card) and poisoned-request quarantine
    (``finish_reason="error"``).
  * :mod:`~repro_torch.serve.resilience.checkpoint` — graceful
    drain/restore: live requests checkpointed to JSON and resumed
    mid-generation by a fresh engine, in either package.

Armed via ``EngineConfig.fault_injector`` / ``EngineConfig.resilience``;
the service layer (watchdog, drain command) builds on top.
"""

from repro_torch.serve.resilience.checkpoint import (CHECKPOINT_VERSION,
                                                     checkpoint_requests,
                                                     request_record,
                                                     restore_requests,
                                                     thaw_request)
from repro_torch.serve.resilience.faults import (SITES, FaultEvent,
                                                 FaultInjected,
                                                 FaultInjector)
from repro_torch.serve.resilience.guard import ResilienceConfig, StepGuard

__all__ = [
    "SITES", "FaultEvent", "FaultInjected", "FaultInjector",
    "ResilienceConfig", "StepGuard",
    "CHECKPOINT_VERSION", "checkpoint_requests", "request_record",
    "restore_requests", "thaw_request",
]
