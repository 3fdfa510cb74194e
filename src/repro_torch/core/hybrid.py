"""OpenCL-style command queue over one device.

The JAX package's ``CommandQueue`` builds one executable per kernel name
(``build``: lower and compile once) and dispatches it on the mesh at every
``enqueue``.  Here a "kernel" is a named step function, and
``build(name, fn, *example_args)`` makes its executable: on the card a
CUDA graph (:class:`StepGraph`) captured once and replayed at every later
``enqueue(name, fn, *args)``; on the CPU, which has no graphs, the body
itself, run eagerly.  ``enqueue`` builds on first use, counts the launch
and stamps ``KernelEvent`` times, and ``finish()`` is the ``clFinish`` —
``torch.cuda.synchronize()`` on the card, a no-op on the CPU (where every
call has already completed when it returns).  The queue of one PE of a
grid of PE processes runs its steps eagerly on the card too: a step there
waits on host barriers between its collectives, which a CUDA graph cannot
hold (``CommandQueue.build`` says so; a barrier on the card is later
work).

A :class:`HybridKernel` is the paper's object: an OpenSHMEM program
``fn(grid, *blocks)`` nested in one launch, over the PE stacks of an
emulated :class:`~repro_torch.core.shmem.ShmemGrid`.  ``enqueue(kernel,
*blocks)`` runs it eagerly, and on its first launch stamps the event with
the program's per-PE FLOPs and wire bytes, read off the grid's counters
(the JAX queue reads them from the compiled executable on its first
build).
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.core.shmem import ShmemGrid
from repro_torch.kernels import add_launches, count_delta, launch_counts


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
    build_time_s: float = 0.0       # summed over every build of the name
    first_enqueue_t: float = 0.0    # perf_counter at first enqueue (0 = never)
    last_enqueue_t: float = 0.0     # perf_counter at latest enqueue
    last_done_t: float = 0.0        # perf_counter at the finish() that drained it

    @property
    def active_span_s(self) -> float:
        """Wall-clock span this kernel was being launched over."""
        end = self.last_done_t or self.last_enqueue_t
        return max(0.0, end - self.first_enqueue_t) \
            if self.first_enqueue_t else 0.0


def _on_host(a) -> bool:
    return isinstance(a, torch.Tensor) and a.device.type == "cpu"


class StepGraph:
    """A step body captured once as a CUDA graph and replayed at each call.

    The tensor arguments that lie on the host are the step's operands: the
    graph reads them from static device buffers made from the example
    args, and each call copies the new values in before the replay
    (without waiting, when they are pinned).  Every other argument — device
    tensors, containers of them such as the weights and the state arena,
    ``None`` — is bound by address at capture: each call passes the very
    same objects, and their storage must not be replaced while the graph
    lives.

    Building runs the body once on the example args on the capture stream,
    so that lazy set-up (library loads, cuBLAS workspaces, caches) happens
    outside the capture, and then captures one call.  Neither run is a
    launch of the step: the kernels' counts (:mod:`repro_torch.kernels`)
    are put back as they were, and each replay adds what the captured call
    launched.  The output is the graph's own tensor in the queue's memory
    pool: it stays valid only until the next call of any step of the
    queue.

    Python's cyclic collector is off from the warm-up to the end of the
    capture.  A collection there would finalize whatever dead objects it
    finds on the capturing thread, such as a dropped engine's graphs,
    pinned buffers and events, and a CUDA call such a finalizer makes
    while a capture runs in ``"global"`` mode invalidates the capture
    (``cudaErrorStreamCaptureInvalidated`` at its end).  PyTorch's
    ``torch.cuda.graph`` no longer collects before it captures."""

    def __init__(self, fn: Callable, example_args, *, pool, stream):
        dev = stream.device
        self.bound = tuple(example_args)
        self.static = {i: torch.empty(a.shape, dtype=a.dtype, device=dev)
                       for i, a in enumerate(self.bound) if _on_host(a)}
        args = [self.static.get(i, a) for i, a in enumerate(self.bound)]
        before = launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for i, buf in self.static.items():
                    buf.copy_(self.bound[i])
                fn(*args)
            warm = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn(*args)
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.launches = count_delta(warm, after)
        add_launches(count_delta(before, after), sign=-1)
        torch.cuda.current_stream(dev).wait_stream(stream)

    def __call__(self, *args):
        if len(args) != len(self.bound):
            raise TypeError(f"StepGraph: {len(args)} arguments, captured "
                            f"with {len(self.bound)}")
        for i, a in enumerate(args):
            buf = self.static.get(i)
            if buf is not None:
                buf.copy_(a, non_blocking=True)
            elif a is not self.bound[i]:
                raise ValueError(f"StepGraph: argument {i} is not the object "
                                 f"the graph was captured with")
        self.graph.replay()
        add_launches(self.launches)
        return self.out


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
    """In-order command queue for one device (cl_command_queue analogue).

    On the card every named step is built once into a :class:`StepGraph`.
    All of a queue's graphs share one memory pool, since the queue runs one
    step at a time on one stream; so a built step's output stays valid only
    until the next enqueue on the queue (the JAX queue returns fresh
    buffers).  A body that writes state in place is built with example
    args whose writes are harmless before its first enqueue: on the card
    ``build`` runs it once on them."""

    GRID_EAGER = ("a step on a grid of {n} PE processes waits on host "
                  "barriers between its collectives, which a CUDA graph "
                  "cannot capture: such steps run eagerly until the grid "
                  "has a barrier on the card")

    def __init__(self, device: torch.device, grid=None):
        """``grid``: this process's PeGrid when it is one PE of several;
        its steps are then not captured, for ``eager_reason``."""
        self.device = torch.device(device)
        n = 1 if grid is None else grid.n_pes
        self.eager_reason = self.GRID_EAGER.format(n=n) if n > 1 else None
        self.capture = self.device.type == "cuda" and n == 1
        self.events: Dict[str, KernelEvent] = {}
        self._compiled: Dict[str, Callable] = {}
        self._pending: List[str] = []
        self.max_depth = 0              # high-water mark of in-flight enqueues
        self._pool = None               # the graphs' memory pool (the card)
        self._stream = None             # the capture stream (the card)

    @property
    def depth(self) -> int:
        """Number of enqueued-but-not-drained dispatches (queue occupancy)."""
        return len(self._pending)

    @property
    def n_executables(self) -> int:
        """Distinct built executables held by this queue."""
        return len(self._compiled)

    def _executable(self, fn: Callable, example_args) -> Callable:
        """The card's captured graph of ``fn``, or ``fn`` itself on the CPU
        and on a grid of several PEs (on the card uploading the host
        operands at every call, as a graph's replay copies them in)."""
        if not self.capture:
            if self.device.type != "cuda":
                return fn
            dev = self.device

            def run(*args):
                return fn(*(a.to(dev) if _on_host(a) else a for a in args))
            return run
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        return StepGraph(fn, example_args, pool=self._pool,
                         stream=self._stream)

    def build(self, name: str, fn: Callable, *example_args) -> Callable:
        """clBuildProgram: make the executable of step ``name`` (see the
        class note); ``build_time_s`` accumulates across rebuilds.  A
        capture that fails raises."""
        t0 = time.perf_counter()
        try:
            exe = self._executable(fn, example_args)
        except RuntimeError as e:
            threads = sorted(t.name for t in threading.enumerate())
            raise RuntimeError(
                f"CommandQueue: building step {name!r} on {self.device} "
                f"failed; threads alive: {threads}") from e
        ev = self.events.setdefault(name, KernelEvent(name))
        ev.build_time_s += time.perf_counter() - t0
        self._compiled[name] = exe
        return exe

    def enqueue(self, kernel: Union[str, HybridKernel], *args):
        """clEnqueueNDRangeKernel: ``enqueue(name, fn, *args)`` runs step
        ``name``'s executable on ``args``, building it from ``fn`` on first
        use; ``enqueue(hybrid_kernel, *blocks)`` runs the kernel's program
        on its grid (asynchronously on the card).  Either records the
        launch under its name."""
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
            exe = self._compiled.get(name)
            if exe is None:
                exe = self.build(name, fn, *args)
            out = exe(*args)
            ev = self.events[name]
        ev.launches += 1
        now = time.perf_counter()
        if not ev.first_enqueue_t:
            ev.first_enqueue_t = now
        ev.last_enqueue_t = now
        self._pending.append(name)
        self.max_depth = max(self.max_depth, len(self._pending))
        return out

    def finish(self) -> None:
        """clFinish: block until all enqueued work completes."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        for name in set(self._pending):
            self.events[name].last_done_t = now
        self._pending.clear()
