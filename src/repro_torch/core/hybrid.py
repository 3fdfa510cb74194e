"""OpenCL-style command queue over one device.

The JAX package's ``CommandQueue`` builds one shard_map executable per
kernel name and dispatches it on the mesh.  PyTorch runs eagerly, so here a
"kernel" is a named step function: ``enqueue(name, fn, *args)`` calls it,
counts the launch and stamps ``KernelEvent`` times, and ``finish()`` is the
``clFinish`` — ``torch.cuda.synchronize()`` on the card, a no-op on the
CPU (where every call has already completed when it returns).

A :class:`HybridKernel` is the paper's object: an OpenSHMEM program
``fn(grid, *blocks)`` nested in one launch, over the PE stacks of an
emulated :class:`~repro_torch.core.shmem.ShmemGrid`.  ``enqueue(kernel,
*blocks)`` runs it, and on its first launch stamps the event with the
program's per-PE FLOPs and wire bytes, read off the grid's counters (the
JAX queue reads them from the compiled executable on its first build).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.core.shmem import ShmemGrid


@dataclasses.dataclass
class KernelEvent:
    """Profiling record for one named step (cl_event analogue).

    Timestamps mirror OpenCL's CL_PROFILING_COMMAND_QUEUED/COMPLETE: every
    enqueue is stamped with ``time.perf_counter()`` so host-side throughput
    can be derived purely from event records."""

    name: str
    flops: float = 0.0              # per PE per launch (hybrid kernels)
    collective_bytes: float = 0.0   # per PE per launch (hybrid kernels)
    launches: int = 0
    first_enqueue_t: float = 0.0    # perf_counter at first enqueue (0 = never)
    last_enqueue_t: float = 0.0     # perf_counter at latest enqueue
    last_done_t: float = 0.0        # perf_counter at the finish() that drained it


class HybridKernel:
    """A device kernel: an OpenSHMEM program nested in one launch.

    ``fn(grid, *blocks)`` is written in device-level style against the
    :class:`ShmemGrid`; its operands and results are PE stacks."""

    def __init__(self, fn: Callable, *, grid: ShmemGrid,
                 name: Optional[str] = None):
        self.fn = fn
        self.grid = grid
        self.name = name or getattr(fn, "__name__", "kernel")


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

    def enqueue(self, kernel: Union[str, HybridKernel], *args):
        """clEnqueueNDRangeKernel: ``enqueue(name, fn, *args)`` runs
        ``fn(*args)``, ``enqueue(hybrid_kernel, *blocks)`` runs the kernel's
        program on its grid (asynchronously on the card), and either records
        the launch under its name."""
        if isinstance(kernel, HybridKernel):
            name, grid = kernel.name, kernel.grid
            flops0, bytes0 = grid.flops, grid.comm_bytes
            out = kernel.fn(grid, *args)
            first = name not in self.events
            ev = self.events.setdefault(name, KernelEvent(name))
            if first:
                ev.flops = float(grid.flops - flops0)
                ev.collective_bytes = float(grid.comm_bytes - bytes0)
        else:
            name, fn, args = kernel, args[0], args[1:]
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
