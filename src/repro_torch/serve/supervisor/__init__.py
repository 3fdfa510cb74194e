"""Crash-safe replica supervision for the serving engine
(``repro.serve.supervisor`` over the port's engine on one device).

Three pieces:

  * :mod:`~repro_torch.serve.supervisor.spec`: :class:`EngineSpec`, the
    picklable recipe a fresh process rebuilds the identical engine from
    (weights from the seed, or from a ``torch.save`` file).
  * :mod:`~repro_torch.serve.supervisor.worker`: the child-process drive
    loop: step, pump token events, periodic incremental drain checkpoints
    (tmp + fsync + rename, CRC header, previous-good rotation).  On the
    card its main thread owns every CUDA call.
  * :mod:`~repro_torch.serve.supervisor.supervisor`:
    :class:`ReplicaSupervisor`, the asyncio front-end that detects replica
    death (exit / pipe EOF / watchdog), restores the last good checkpoint
    into a freshly spawned worker, resumes every open stream with
    high-water-mark token dedup, and contains crash loops behind an
    exponential-backoff ``max_respawns`` budget.
"""

from repro_torch.serve.supervisor.spec import EngineSpec
from repro_torch.serve.supervisor.supervisor import (ReplicaSupervisor,
                                                     SupervisorConfig)
from repro_torch.serve.supervisor.worker import WorkerConfig, worker_main

__all__ = [
    "EngineSpec", "ReplicaSupervisor", "SupervisorConfig", "WorkerConfig",
    "worker_main",
]
