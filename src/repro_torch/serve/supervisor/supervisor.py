"""Crash-safe replica supervisor: checkpointed handoff to a fresh process
(``repro.serve.supervisor.supervisor`` over the port's engine).

:class:`ReplicaSupervisor` is the process-boundary sibling of
:class:`~repro_torch.serve.service.service.GenerateService`: the same
asyncio client face (``submit() -> ServiceStream``, bounded admission,
metrics), but the engine drive loop runs in a CHILD process
(``worker.worker_main``, ``multiprocessing`` spawn: a forked child cannot
use the parent's CUDA context) that takes periodic incremental drain
checkpoints.  When the replica dies (process exit, pipe EOF, or a step
overstaying the watchdog deadline) the supervisor spawns a fresh worker,
restores the last GOOD checkpoint into it, re-queues every in-flight
request, and the open :class:`ServiceStream`\\ s resume transparently:

  * restored requests replay prompt + checkpointed outputs and continue;
    requests missing from the checkpoint are re-submitted from their
    original record and recompute from scratch;
  * the re-execution is taken to reproduce every already-delivered token,
    and the supervisor deduplicates them against each stream's HIGH-WATER
    MARK (tokens carry absolute output indices on the event pipe), so
    clients see zero duplicated and zero dropped tokens across any number
    of failovers.

That premise holds in fp32: a restored request replays its outputs on the
chunk path, which gives the decode path's tokens.  **In bf16 on the card
it does not**: the chunk and decode paths round differently, so a token
that a new incarnation replays below a stream's high-water mark may differ
from the one already delivered.  The dedup then drops it silently and the
stream goes on from a history the client never saw.  The protocol is the
reference's and is kept; ``chip_smoke.py``'s ``supervisor`` phase counts
those replay divergences.

Crash-loop containment: respawns back off exponentially
(:class:`~repro_torch.runtime.retry.RetryPolicy` with ``growth > 1``), and
a ``max_respawns`` budget, counted since the last successful checkpoint
because a checkpoint IS forward progress, ends the loop: surviving streams
finish with ``finish_reason == "error"`` (tokens delivered so far
retained), :attr:`healthy` turns False, and new submits fail fast.

Each failover is recorded in :attr:`failovers` (host clock): when it was
detected, when the dead process was reaped, when the next incarnation was
spawned and ready (with what the worker measured of its own start), and
when its first resumed token arrived.  ``_kill_worker`` waits 5 s for a
killed process to exit; a CUDA process may take longer to release its
memory, which is why the record keeps the card's free memory at ready.
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.runtime.retry import RetryPolicy
from repro_torch.serve.engine.api import Completion
from repro_torch.serve.engine.request import Request, SamplingParams
from repro_torch.serve.resilience.checkpoint import (load_checkpoint,
                                                     request_record)
from repro_torch.serve.service.metrics import RequestMetrics, ServiceMetrics
from repro_torch.serve.service.service import (AdmissionRejected,
                                               ServiceError, ServiceStream,
                                               _resolve)
from repro_torch.serve.supervisor.spec import EngineSpec
from repro_torch.serve.supervisor.worker import WorkerConfig, worker_main


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    checkpoint_path: str              # the incremental drain-handoff file
    checkpoint_every_steps: int = 8
    fsync: bool = True
    max_pending: int = 64             # in-flight bound, as GenerateService
    idle_wait_s: float = 0.005        # event-pipe poll timeout when idle
    # replica-death detection beyond process exit: a step in flight longer
    # than this (after the incarnation's first COMPLETED step: its graph
    # capture gets amnesty) has the worker killed and failed over.  On the
    # card each new (bucket, L) captures a graph in its first step, 0.1-0.3
    # s each, so the timeout must sit above one capture.  None disables it.
    watchdog_timeout_s: Optional[float] = None
    # crash-loop containment: respawns allowed since the last successful
    # checkpoint before the supervisor gives up and reports unhealthy
    max_respawns: int = 3
    respawn_backoff: RetryPolicy = RetryPolicy(
        max_retries=0, backoff_s=0.05, growth=2.0, max_backoff_s=2.0)
    ready_timeout_s: float = 300.0    # child torch import + engine build
    heartbeat_s: float = 0.02

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1: {self.max_pending}")
        if self.max_respawns < 0:
            raise ValueError(f"max_respawns must be >= 0: "
                             f"{self.max_respawns}")
        if self.watchdog_timeout_s is not None \
                and self.watchdog_timeout_s <= 0:
            raise ValueError(f"watchdog_timeout_s must be > 0: "
                             f"{self.watchdog_timeout_s}")


class _SupStream:
    """Supervisor-side bookkeeping for one live stream."""

    __slots__ = ("handle", "record", "hwm", "delivered", "tok_times")

    def __init__(self, handle: ServiceStream, record: dict):
        self.handle = handle
        self.record = record          # FRESH submit record (re-submit seed)
        self.hwm = 0                  # tokens delivered to the client
        self.delivered: List[int] = []
        self.tok_times: List[float] = []


class ReplicaSupervisor:
    """Async front-end owning one replica worker process (see module doc).

    Use like :class:`GenerateService`::

        async with ReplicaSupervisor(spec, SupervisorConfig(...)) as sup:
            stream = await sup.submit(prompt, max_tokens=32)
            async for tok in stream:
                ...
    """

    def __init__(self, spec: EngineSpec, config: SupervisorConfig, *,
                 metrics: Optional[ServiceMetrics] = None):
        self.spec = spec
        self.config = config
        self.metrics = metrics or ServiceMetrics()
        self._cmd: "queue.Queue" = queue.Queue()
        self._streams: Dict[str, _SupStream] = {}   # pump-thread owned
        self._stats_futs: list = []                 # pump-thread owned
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._error: Optional[BaseException] = None
        self._unhealthy_reason: Optional[str] = None
        import multiprocessing
        self._ctx = multiprocessing.get_context("spawn")
        self._proc = None
        self._to_worker = None
        self._from_worker = None
        self._pipe_dead = False
        self._busy_s = 0.0            # last heartbeat's in-flight step age
        self._steps_done = 0          # last heartbeat's completed steps
        self._respawns_since_ckpt = 0
        self.n_spawns = 0             # worker incarnations (incl. first)
        self.n_failovers = 0          # crash-triggered respawn attempts
        self.n_ckpt_corruptions = 0   # injected-bit-rot checkpoints seen
        self.incarnations: List[dict] = []   # each worker's ready info
        self.failovers: List[dict] = []      # host-clock failover records

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._run,
                                        name="replica-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        """Stop the worker and the pump thread; re-raises a supervisor
        error (worker STARTUP failure: crash-loop containment is a
        reported state, not an exception)."""
        if self._thread is None:
            return
        self._stop_evt.set()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._thread.join)
        self._thread = None
        if self._error is not None:
            raise self._error

    async def __aenter__(self) -> "ReplicaSupervisor":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def healthy(self) -> bool:
        """False once the crash-loop budget is exhausted (or the
        supervisor itself died)."""
        return self._error is None and self._unhealthy_reason is None

    # -- client face ---------------------------------------------------------

    async def submit(self, prompt: Sequence[int], *,
                     max_tokens: int = 16, temperature: float = 0.0,
                     eos_token_id: Optional[int] = None, seed: int = 0,
                     priority: int = 0, tenant: str = "default",
                     ttft_deadline_s: Optional[float] = None
                     ) -> ServiceStream:
        """Submit one request; returns its async token stream (the same
        :class:`ServiceStream` the in-process service hands out)."""
        if self._thread is None:
            raise RuntimeError("supervisor not started")
        if self._unhealthy_reason is not None:
            raise ServiceError(
                f"replica unhealthy: {self._unhealthy_reason}")
        if self._error is not None or not self._thread.is_alive():
            raise ServiceError("supervisor is dead") from self._error
        with self._inflight_lock:
            if self._inflight >= self.config.max_pending:
                self.metrics.on_rejected()
                raise AdmissionRejected(
                    f"max_pending={self.config.max_pending} requests "
                    f"in flight")
            self._inflight += 1
        try:
            req = Request(prompt,
                          SamplingParams(max_tokens=max_tokens,
                                         temperature=temperature,
                                         eos_token_id=eos_token_id,
                                         seed=seed),
                          priority=priority, tenant=tenant,
                          ttft_deadline_s=ttft_deadline_s)
        except Exception:
            self._finished()
            raise
        req.submit_t = time.perf_counter()
        handle = ServiceStream(self, req)
        self.metrics.on_submitted()
        self._cmd.put(("submit", handle))
        return handle

    async def replica_stats(self) -> dict:
        """Resource-accounting snapshot from the CURRENT worker (pool/slot
        occupancy, live requests, injected-fault counts, its step replays
        and kernel launches)."""
        if self._thread is None or not self._thread.is_alive():
            raise ServiceError("supervisor is not running")
        fut = asyncio.get_running_loop().create_future()
        self._cmd.put(("stats", fut))
        return await fut

    async def kill_replica(self) -> None:
        """Hard-kill the worker mid-generation (test/chaos surface: the
        deterministic stand-in for an external SIGKILL)."""
        if self._thread is None or not self._thread.is_alive():
            raise ServiceError("supervisor is not running")
        self._cmd.put(("kill", None))

    def _cancel(self, request_id: str) -> None:   # ServiceStream hook
        self._cmd.put(("cancel", request_id))

    def _finished(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    # -- pump thread ---------------------------------------------------------

    def _run(self) -> None:
        try:
            self._spawn()
            while not self._stop_evt.is_set():
                self._forward_commands()
                self._drain_events(self.config.idle_wait_s)
                if self._stop_evt.is_set():
                    break
                dead = self._pipe_dead or self._proc is None \
                    or not self._proc.is_alive()
                if dead:
                    self._failover(
                        "worker process exited"
                        + (f" (exitcode {self._proc.exitcode})"
                           if self._proc is not None else ""))
                elif self._watchdog_tripped():
                    self._kill_worker()
                    self._failover(
                        f"watchdog: step in flight > "
                        f"{self.config.watchdog_timeout_s}s")
        except BaseException as e:      # noqa: BLE001 — surfaced on stop()
            self._error = e
        finally:
            self._teardown()

    # -- worker process management -------------------------------------------

    def _spawn(self) -> None:
        """Start one worker incarnation and wait for its engine build."""
        cmd_r, cmd_w = self._ctx.Pipe(duplex=False)
        evt_r, evt_w = self._ctx.Pipe(duplex=False)
        wcfg = WorkerConfig(
            checkpoint_path=self.config.checkpoint_path,
            checkpoint_every_steps=self.config.checkpoint_every_steps,
            fsync=self.config.fsync,
            heartbeat_s=self.config.heartbeat_s)
        proc = self._ctx.Process(target=worker_main,
                                 args=(self.spec, cmd_r, evt_w, wcfg),
                                 name="replica-worker", daemon=True)
        t_spawn = time.time()
        proc.start()
        cmd_r.close()                   # parent keeps only its own ends
        evt_w.close()
        self._proc, self._to_worker, self._from_worker = proc, cmd_w, evt_r
        self._pipe_dead = False
        self._busy_s, self._steps_done = 0.0, 0
        self.n_spawns += 1
        deadline = time.monotonic() + self.config.ready_timeout_s
        while True:                     # block until ("ready", info)
            if self._from_worker.poll(0.1):
                try:
                    ev = self._from_worker.recv()
                except (EOFError, OSError):
                    raise ServiceError(
                        "replica worker died during startup") from None
                if ev[0] == "ready":
                    info = dict(ev[1] if len(ev) > 1 else {},
                                t_spawn=t_spawn, t_ready=time.time())
                    self.incarnations.append(info)
                    return
                self._handle_event(ev)
            elif not proc.is_alive():
                raise ServiceError(
                    f"replica worker died during startup "
                    f"(exitcode {proc.exitcode})")
            elif time.monotonic() > deadline:
                proc.kill()
                raise ServiceError(
                    f"replica worker startup exceeded "
                    f"{self.config.ready_timeout_s}s")

    def _kill_worker(self) -> None:
        if self._proc is not None and self._proc.is_alive():
            self._proc.kill()
            self._proc.join(5.0)

    def _close_worker(self) -> None:
        self._kill_worker()
        for conn in (self._to_worker, self._from_worker):
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        self._proc = self._to_worker = self._from_worker = None

    def _send_worker(self, item) -> None:
        if self._to_worker is None:
            return
        try:
            self._to_worker.send(item)
        except (BrokenPipeError, OSError):
            self._pipe_dead = True      # liveness check fails over; the
            #                             re-submission pass re-sends

    def _watchdog_tripped(self) -> bool:
        t = self.config.watchdog_timeout_s
        # first-step amnesty: the incarnation's first step builds (on the
        # card: captures) its step and must not read as a wedge
        return t is not None and self._steps_done > 0 and self._busy_s > t

    # -- command / event plumbing --------------------------------------------

    def _forward_commands(self) -> None:
        while True:
            try:
                op, arg = self._cmd.get_nowait()
            except queue.Empty:
                return
            if op == "submit":
                handle: ServiceStream = arg
                self._streams[handle.request_id] = _SupStream(
                    handle, request_record(handle.request))
                self._send_worker(("submit",
                                   self._streams[handle.request_id].record))
            elif op == "cancel":
                self._send_worker(("cancel", arg))
            elif op == "stats":
                self._stats_futs.append(arg)
                self._send_worker(("stats", None))
            elif op == "kill":
                self._send_worker(("kill", None))

    def _drain_events(self, first_timeout: float) -> None:
        conn = self._from_worker
        if conn is None:
            return
        got = False
        try:
            while conn.poll(0 if got else first_timeout):
                ev = conn.recv()
                got = True
                self._handle_event(ev)
        except (EOFError, OSError):
            self._pipe_dead = True

    def _handle_event(self, ev) -> None:
        kind = ev[0]
        if kind == "tok":
            _, rid, start, toks = ev
            st = self._streams.get(rid)
            if st is None:
                return                  # cancelled/finished: late tokens
            now = time.perf_counter()
            for i, t in enumerate(toks):
                if start + i < st.hwm:
                    continue            # replayed by a re-execution: dedup
                st.delivered.append(int(t))
                st.tok_times.append(now)
                st.handle._push(("tok", int(t)))
                st.hwm += 1
                if self.failovers and "t_first_token" not in \
                        self.failovers[-1]:
                    self.failovers[-1]["t_first_token"] = time.time()
        elif kind == "fin":
            _, rid, comp = ev
            st = self._streams.pop(rid, None)
            if st is None:
                return
            for t in comp.tokens[st.hwm:]:      # defensive: fin follows pump
                st.delivered.append(int(t))
                st.handle._push(("tok", int(t)))
                st.hwm += 1
            self._observe(st, comp)
            self._finished()
            st.handle._push(("end", comp))
        elif kind == "ckpt":
            corrupted = len(ev) > 2 and ev[2]
            if corrupted:
                # injected bit rot: the file on disk is NOT forward
                # progress (a restore falls back past it), so it neither
                # resets the crash-loop budget nor counts as a checkpoint
                self.n_ckpt_corruptions += 1
            else:
                self._respawns_since_ckpt = 0
                self.metrics.on_checkpoint(ev[1])
        elif kind == "hb":
            _, self._busy_s, self._steps_done = ev
        elif kind == "stats":
            if self._stats_futs:
                _resolve(self._loop, self._stats_futs.pop(0), value=ev[1])
        elif kind == "subfail":
            _, rid, exc = ev
            st = self._streams.pop(rid, None)
            if st is not None:
                self._finished()
                st.handle._push(("err", exc))
        # "bye" / "err": the worker is exiting; the liveness check (or the
        # stop path) owns what happens next

    def _observe(self, st: _SupStream, comp: Completion) -> None:
        r = st.handle.request
        itl = [b - a for a, b in zip(st.tok_times, st.tok_times[1:])]
        self.metrics.observe(RequestMetrics(
            request_id=comp.request_id, tenant=r.tenant,
            priority=r.priority, finish_reason=comp.finish_reason,
            n_tokens=len(comp.tokens), ttft_s=comp.ttft_s,
            queue_wait_s=comp.queue_wait_s, itl_s=itl,
            n_prompt_tokens=len(comp.prompt)))

    # -- failover ------------------------------------------------------------

    def _failover(self, reason: str) -> None:
        """The tentpole path: contain or respawn-and-restore (module doc)."""
        self.n_failovers += 1
        t0 = time.perf_counter()
        rec = {"reason": reason, "t_detect": time.time()}
        # 1. squeeze every event the dead worker buffered out of the pipe:
        #    high-water marks must reflect everything that was delivered,
        #    and the worker pumps BEFORE each checkpoint, so afterwards
        #    hwm >= the checkpoint's output length for every live stream
        if self._from_worker is not None:
            try:
                while self._from_worker.poll(0):
                    self._handle_event(self._from_worker.recv())
            except (EOFError, OSError):
                pass
        proc = self._proc
        self._close_worker()
        rec["t_exit"] = time.time()
        rec["exitcode"] = proc.exitcode if proc is not None else None
        self.failovers.append(rec)
        err = ServiceError(f"replica restarted: {reason}")
        for fut in self._stats_futs:
            _resolve(self._loop, fut, exc=err)
        self._stats_futs.clear()
        # 2. crash-loop containment (budget counts respawns since the last
        #    successful checkpoint: a checkpoint is forward progress)
        self._respawns_since_ckpt += 1
        if self._respawns_since_ckpt > self.config.max_respawns:
            self._contain(reason)
            return
        backoff = self.config.respawn_backoff.delay_s(
            self._respawns_since_ckpt)
        if backoff:
            time.sleep(backoff)
        # 3. last good checkpoint; both current and previous-good corrupt
        #    (or none yet) degrades to full recompute: slower, still
        #    zero-loss where re-execution reproduces the delivered tokens
        recs: Dict[str, dict] = {}
        try:
            payload = load_checkpoint(self.config.checkpoint_path)
            recs = {r["request_id"]: r for r in payload["requests"]}
        except (OSError, ValueError):
            recs = {}
        rec["restored"] = len(recs)
        # 4. fresh incarnation (an unspawnable worker raises out of _run:
        #    that is a supervisor death, not a crash loop we can ride out)
        self._spawn()
        rec["incarnation"] = self.incarnations[-1]
        # 5. re-admit every live stream in submission order: checkpointed
        #    ones resume from their record (outputs + rng state), the rest
        #    restart from their original submit record; the replayed
        #    prefix is deduplicated against each stream's high-water mark.
        #    Checkpointed requests whose stream already finished (fin
        #    delivered after the checkpoint was cut) are NOT re-admitted.
        for rid, st in self._streams.items():
            self._send_worker(("submit", recs.get(rid, st.record)))
        self.metrics.on_restart(time.perf_counter() - t0)

    def _contain(self, reason: str) -> None:
        """Respawn budget exhausted: finish every surviving stream with
        ``finish_reason == "error"`` (tokens delivered so far retained)
        and report unhealthy; new submits fail fast."""
        self._unhealthy_reason = (
            f"crash loop: {self._respawns_since_ckpt - 1} respawns since "
            f"the last good checkpoint exhausted the "
            f"max_respawns={self.config.max_respawns} budget "
            f"(last failure: {reason})")
        for rid, st in list(self._streams.items()):
            r = st.handle.request
            comp = Completion(request_id=rid, prompt=list(r.prompt),
                              tokens=list(st.delivered),
                              finish_reason="error",
                              n_preemptions=r.n_preemptions)
            self._observe(st, comp)
            self._finished()
            st.handle._push(("end", comp))
        self._streams.clear()
        self._stop_evt.set()

    # -- shutdown ------------------------------------------------------------

    def _teardown(self) -> None:
        if self._proc is not None:
            if self._error is None and self._proc.is_alive():
                self._send_worker(("stop", None))
                self._proc.join(10.0)
            self._close_worker()
        err = self._error or ServiceError("supervisor stopped")
        for st in self._streams.values():
            self._finished()
            st.handle._push(("err", err))
        self._streams.clear()
        for fut in self._stats_futs:
            _resolve(self._loop, fut, exc=err)
        self._stats_futs.clear()
        while True:                     # wake queued-but-unforwarded clients
            try:
                op, arg = self._cmd.get_nowait()
            except queue.Empty:
                break
            if op == "submit":
                self._finished()
                arg._push(("err", err))
            elif op == "stats":
                _resolve(self._loop, arg, exc=err)
