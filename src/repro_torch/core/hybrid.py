"""OpenCL-style command queue over one device.

The JAX package's ``CommandQueue`` builds one shard_map executable per
kernel name and dispatches it on the mesh.  PyTorch runs eagerly, so here a
"kernel" is a named step function: ``enqueue(name, fn, *args)`` calls it,
counts the launch and stamps ``KernelEvent`` times, and ``finish()`` is the
``clFinish`` — ``torch.cuda.synchronize()`` on the card, a no-op on the
CPU (where every call has already completed when it returns).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import torch


@dataclasses.dataclass
class KernelEvent:
    """Profiling record for one named step (cl_event analogue).

    Timestamps mirror OpenCL's CL_PROFILING_COMMAND_QUEUED/COMPLETE: every
    enqueue is stamped with ``time.perf_counter()`` so host-side throughput
    can be derived purely from event records."""

    name: str
    launches: int = 0
    first_enqueue_t: float = 0.0    # perf_counter at first enqueue (0 = never)
    last_enqueue_t: float = 0.0     # perf_counter at latest enqueue
    last_done_t: float = 0.0        # perf_counter at the finish() that drained it


class CommandQueue:
    """In-order command queue for one device (cl_command_queue analogue)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.events: Dict[str, KernelEvent] = {}
        self._pending: List[str] = []

    @property
    def n_executables(self) -> int:
        """Distinct step names launched through this queue."""
        return len(self.events)

    def enqueue(self, name: str, fn: Callable, *args):
        """clEnqueueNDRangeKernel: run ``fn(*args)`` (asynchronously on the
        card) and record the launch under ``name``."""
        out = fn(*args)
        ev = self.events.setdefault(name, KernelEvent(name))
        ev.launches += 1
        now = time.perf_counter()
        if not ev.first_enqueue_t:
            ev.first_enqueue_t = now
        ev.last_enqueue_t = now
        self._pending.append(name)
        return out

    def finish(self) -> None:
        """clFinish: block until all enqueued work completes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        for name in set(self._pending):
            self.events[name].last_done_t = now
        self._pending.clear()
