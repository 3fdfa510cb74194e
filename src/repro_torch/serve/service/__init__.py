"""Async serving service over the continuous-batching engine
(``repro.serve.service`` over the port's engine on one device).

Layering (top = closest to the user):

    service.GenerateService    asyncio front-end: concurrent clients,
                               per-request streams, backpressure,
                               clean async cancellation
      admission.make_policy    SLO-aware admission (fifo / deadline /
                               fair_share) plugged into the engine
                               Scheduler's AdmissionPolicy hook
      metrics.ServiceMetrics   per-request TTFT / ITL / queue-wait records,
                               rolling p50/p99, shed/reject counters
        engine.ServingEngine   the synchronous drive loop (one thread)

Driven open-loop (Poisson arrivals) on the card by ``chip_smoke.py``'s
``service`` phase and by ``launch/serve.py --service``.
"""

from repro_torch.serve.service.admission import (DeadlineAdmission,
                                                 FairShareAdmission,
                                                 make_policy)
from repro_torch.serve.service.metrics import (RequestMetrics,
                                               ServiceMetrics, percentile)
from repro_torch.serve.service.service import (AdmissionRejected,
                                               GenerateService,
                                               ServiceConfig, ServiceError,
                                               ServiceStream)

__all__ = [
    "AdmissionRejected", "DeadlineAdmission", "FairShareAdmission",
    "GenerateService", "RequestMetrics", "ServiceConfig", "ServiceError",
    "ServiceMetrics", "ServiceStream", "make_policy", "percentile",
]
