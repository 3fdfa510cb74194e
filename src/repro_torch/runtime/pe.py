"""A grid of PE processes: what ``shard_map`` gives the JAX package.

The JAX package runs its SHMEM programs as one program per device of a
mesh.  The port runs them as one process per PE: :func:`run_pes` spawns
``q * r`` processes (the ``spawn`` start method; a forked child would
inherit the parent's CUDA state), each runs ``target(grid, *args)`` on its
own :class:`~repro_torch.core.pe_grid.PeGrid`, and the parent gets every
PE's return value, in PE order.

  * The PEs meet through a ``torch.distributed`` gloo group whose store is
    a file in a fresh directory the parent makes (never a fixed port: two
    grids may start at once, as the CPU tests do under xdist); the heaps'
    handles and the engine's step headers cross over it.  No NCCL.
  * The grid's barrier, after the PE's stream is synchronised, is a host
    barrier over a file mapping in the same directory
    (:class:`HostBarrier`): each PE writes its own arrival count and spins
    until every PE's count has reached it.  A gloo barrier costs 1.1-3.4
    ms among four processes on the H100's host (``chip_smoke.py``'s
    ``grid`` phase, which times both), and a grid step takes 293 of them.
    Its wait names the PE, the collective and the PEs missing when it
    times out; each PE leaves the tag of its collective (name and
    ordinal) beside its count, and a PE that meets a peer in another
    collective raises :class:`CollectiveMismatch` naming both.
  * PE ``p`` runs on ``cuda:{p % device_count}``, or on the CPU when the
    caller asks, where its heap is a shared file mapping in that directory.
  * Every gloo operation has the ``timeout`` given here.  A PE that raises
    reports its traceback and exits; the parent then ends every other PE
    and raises :class:`PeFailed` naming the PE.  A PE that dies without a
    word is reported with its exit code.  No PE outlives the call: the
    parent terminates, then kills, whatever is left, and removes the
    directory.
  * On the card the parent builds the kernel libraries first, so the PEs
    load them and ``nvcc`` runs once, not once per PE.

A child imports the module of its target by name, so a target lives in
``repro_torch`` (a test module imports JAX); :func:`_pe_main` refuses to
return from a PE that has imported ``jax`` or the ``repro`` package.
Arguments cross as pickles: pass seeds, numpy arrays or paths, never CUDA
tensors.  The parent writes the target and its arguments once to a file in
the grid's directory, which every PE reads: handed to each ``Process``,
a pickle larger than a pipe's buffer holds the parent's ``start()`` until
that child has imported torch, so the PEs would start one after another
(about 10 s each on the card's host).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
import zlib
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.partition import MeshPlan


class PeFailed(RuntimeError):
    """A PE of a grid failed; ``pe`` names it (None: the grid timed out)."""

    def __init__(self, pe: Optional[int], detail: str):
        who = f"PE {pe}" if pe is not None else "the PE grid"
        super().__init__(f"{who} failed: {detail}")
        self.pe, self.detail = pe, detail


class CollectiveMismatch(RuntimeError):
    """PEs met at one barrier from different collectives."""


class HostBarrier:
    """A barrier of ``n`` processes over a shared file mapping of one
    line per PE: barrier k is done when every PE's count is at least k.
    Each PE writes only its own line, so there is no race; a PE can run
    at most one barrier ahead, and its count then still satisfies the
    slower PEs' wait.  (A process-local lock around the store is a
    release fence on hosts that order stores weakly.)

    Beside its count each PE writes the tag of what it waits for (the
    collective's name and ordinal, :meth:`wait`'s ``what``) into slot
    ``k % 2`` of its line, before the count.  A PE that has passed
    barrier k reads every peer's slot ``k % 2``: no peer can have
    overwritten it yet (barrier k+2 needs this PE at k+1), so a tag that
    differs is a peer in another collective, which raises
    :class:`CollectiveMismatch` naming both, where it would otherwise
    read another collective's slots."""

    LINE = 64                      # int64 words per PE: four cache lines
    TAG_WORDS = 28                 # a slot: crc32, length, 208 name bytes
    SPIN_S = 200e-6                # pure spin, then yield
    SLEEP_S = 10e-3                # then short sleeps

    def __init__(self, path: str, pe: int, n: int, timeout: float):
        self.flags = np.memmap(path, dtype=np.int64, mode="r+",
                               shape=(n, self.LINE))
        self.raw = self.flags.view(np.uint8).reshape(n, self.LINE * 8)
        self.pe, self.n, self.timeout = pe, n, timeout
        self.count = 0
        self._fence = threading.Lock()

    @classmethod
    def create(cls, path: str, n: int) -> None:
        with open(path, "wb") as f:
            f.truncate(n * cls.LINE * 8)

    @classmethod
    def _slot(cls, count: int) -> int:
        """First word of the tag slot of barrier ``count``."""
        return 1 + (count % 2) * cls.TAG_WORDS

    def _tag_of(self, pe: int, count: int) -> str:
        w = self._slot(count)
        size = int(self.flags[pe, w + 1])
        start = (w + 2) * 8
        return bytes(self.raw[pe, start:start + size]).decode(
            errors="replace")

    def wait(self, what: str = "barrier") -> None:
        """Arrive, then wait: a pure spin on the mapping for the first
        ``SPIN_S`` (no system call: a yield or a sleep costs far more than
        a barrier's skew on a sandboxed host), then spinning with a yield,
        then with short sleeps, until ``timeout`` names who is missing.
        Then every peer's tag is held against this PE's ``what``."""
        self.count += 1
        name = what.encode()[:(self.TAG_WORDS - 2) * 8]
        crc = zlib.crc32(name)
        w = self._slot(self.count)
        with self._fence:
            self.flags[self.pe, w] = crc
            self.flags[self.pe, w + 1] = len(name)
            self.raw[self.pe, (w + 2) * 8:(w + 2) * 8 + len(name)] = \
                np.frombuffer(name, dtype=np.uint8)
            self.flags[self.pe, 0] = self.count
        col = self.flags[:, 0]
        if int(col.min()) < self.count:
            self._spin(col, what)
        tags = self.flags[:, w]
        if (tags != crc).any():
            other = next(k for k in range(self.n) if int(tags[k]) != crc)
            raise CollectiveMismatch(
                f"PE {self.pe}: barrier {self.count} met PE {other} in "
                f"{self._tag_of(other, self.count)!r} while this PE is in "
                f"{what!r}")

    def _spin(self, col, what: str) -> None:
        t0 = time.perf_counter()
        spins = 0
        while int(col.min()) < self.count:
            spins += 1
            if spins % 64:
                continue
            waited = time.perf_counter() - t0
            if waited > self.timeout:
                missing = [k for k in range(self.n)
                           if int(col[k]) < self.count]
                raise TimeoutError(
                    f"PE {self.pe}: {what} (barrier {self.count}) not met "
                    f"within {self.timeout} s; PEs {missing} did not "
                    f"arrive")
            if waited > self.SLEEP_S:
                time.sleep(50e-6)
            elif waited > self.SPIN_S:
                os.sched_yield()


class GlooComm:
    """The host side of a PE grid: the default gloo group for exchanges
    and broadcasts, and the :class:`HostBarrier` for the barrier."""

    def __init__(self, barrier: HostBarrier):
        import torch.distributed as dist
        self._dist = dist
        self.world = dist.get_world_size()
        self._host = barrier

    def barrier(self, what: str = "barrier") -> None:
        self._host.wait(what)

    def all_gather_object(self, obj) -> List[Any]:
        out: List[Any] = [None] * self.world
        self._dist.all_gather_object(out, obj)
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> None:
        """Broadcast a CPU tensor from PE ``src``, in place."""
        self._dist.broadcast(t, src)


def _forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))


def _pe_main(pe: int, q: int, r: int, workdir: str, device: str,
             timeout: float, threads: int, conn) -> None:
    """The entry of PE ``pe``: join the group, build the grid, run the
    target (read from the grid's directory), report."""
    try:
        with open(os.path.join(workdir, "target.pkl"), "rb") as f:
            target, args = pickle.load(f)
        import torch.distributed as dist

        from repro_torch.core.pe_grid import PeGrid
        if device == "cuda":
            dev = torch.device("cuda", pe % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(workdir, "store"),
            rank=pe, world_size=q * r,
            timeout=datetime.timedelta(seconds=timeout))
        barrier = HostBarrier(os.path.join(workdir, "barrier"), pe, q * r,
                              timeout)
        grid = PeGrid(pe, q, r, device=dev, comm=GlooComm(barrier),
                      workdir=workdir)
        result = target(grid, *args)
        grid.close()
        bad = _forbidden_modules()
        if bad:
            raise RuntimeError(f"a PE imported {bad[:4]}: PE processes run "
                               f"repro_torch alone")
        dist.destroy_process_group()
        conn.send(("ok", result))
        conn.close()
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
            conn.close()
        finally:
            os._exit(1)


def _prebuild(device: str) -> None:
    """Build the libraries the PEs load, once, in this process, at once
    (four PEs compiling one library at the same time would each pay the
    whole build)."""
    if device != "cuda":
        return
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.cannon_mm.kernel import build as mm_build
    from repro_torch.kernels.grouped_mm.kernel import build as gmm_build
    from repro_torch.kernels.paged_attention.kernel import \
        build as paged_build
    from repro_torch.kernels.shmem_heap.kernel import build as heap_build
    from repro_torch.kernels.ssd_scan.kernel import build as ssd_build
    builds = (heap_build, paged_build, mm_build, ssd_build, gmm_build)
    with ThreadPoolExecutor(len(builds)) as ex:
        for f in [ex.submit(b) for b in builds]:
            f.result()


def run_pes(target: Callable, plan: MeshPlan, *, args: Sequence = (),
            device: str = "cuda", timeout: float = 120.0,
            deadline: Optional[float] = None, threads: int = 1) -> List[Any]:
    """Run ``target(grid, *args)`` on every PE of ``plan``'s grid, each in
    its own spawned process, and return their results in PE order.

    ``device`` is ``"cuda"`` (PE p on card ``p % device_count``) or
    ``"cpu"`` (``threads`` torch threads a PE); ``timeout`` bounds every
    gloo operation of a PE, ``deadline`` the whole run (seconds; None: no
    bound).  Raises :class:`PeFailed` naming the first PE that failed."""
    fn = getattr(target, "func", target)
    if not getattr(fn, "__module__", "").startswith("repro_torch."):
        raise ValueError(f"a PE target lives in repro_torch (a spawned PE "
                         f"imports its module): {fn!r}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a PE grid on the card needs CUDA; pass "
                           "device='cpu' for the CPU grid")
    _prebuild(device)
    n = plan.n_pes
    workdir = tempfile.mkdtemp(prefix="pe-grid-")
    HostBarrier.create(os.path.join(workdir, "barrier"), n)
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    t_end = None if deadline is None else time.monotonic() + deadline
    try:
        with open(os.path.join(workdir, "target.pkl"), "wb") as f:
            pickle.dump((target, tuple(args)), f)
        for pe in range(n):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_pe_main, daemon=True,
                            name=f"pe{pe}",
                            args=(pe, plan.grid_q, plan.grid_r, workdir,
                                  device, timeout, threads, send))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        results: List[Any] = [None] * n
        pending = set(range(n))
        while pending:
            left = None if t_end is None else t_end - time.monotonic()
            if left is not None and left <= 0:
                raise PeFailed(None, f"not done within {deadline} s "
                                     f"(PEs {sorted(pending)} still running)")
            objs = {conns[pe]: pe for pe in pending}
            objs.update({procs[pe].sentinel: pe for pe in pending})
            for obj in wait(list(objs), timeout=left):
                pe = objs[obj]
                if pe not in pending:
                    continue
                conn = conns[pe]
                if obj is not conn and not conn.poll():
                    procs[pe].join()
                    raise PeFailed(pe, f"exited with code "
                                       f"{procs[pe].exitcode} before it "
                                       f"reported")
                try:
                    kind, payload = conn.recv()
                except EOFError:
                    procs[pe].join()
                    raise PeFailed(pe, f"exited with code "
                                       f"{procs[pe].exitcode} before it "
                                       f"reported") from None
                if kind != "ok":
                    raise PeFailed(pe, payload)
                results[pe] = payload
                pending.discard(pe)
        for p in procs:
            p.join(timeout)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        for c in conns:
            c.close()
        shutil.rmtree(workdir, ignore_errors=True)


def fail_on(grid, pe: int) -> int:
    """A probe target: PE ``pe`` raises after the grid's first barrier, the
    others wait in the next one (the runtime's failure path)."""
    grid.barrier_all()
    if grid.my_pe() == pe:
        raise RuntimeError(f"probe failure on PE {pe}")
    grid.barrier_all()
    return grid.my_pe()


def mismatch_on(grid, pe: int) -> int:
    """A probe target: PE ``pe`` sums over its grid row where the others
    sum over their column (a program whose collectives differ by PE);
    every PE must raise :class:`CollectiveMismatch` at that barrier."""
    x = torch.ones(4, device=grid.device)
    grid.reserve(x.numel() * 4)
    grid.barrier_all()
    y = grid.psum_cols(x) if grid.my_pe() == pe else grid.psum_rows(x)
    return int(y.sum())

