"""Asyncio generate service: many concurrent clients, one engine thread
(``repro.serve.service.service`` over the port's engine).

This is the host-runtime half the source paper's OpenCL host stood for,
grown to a real serving front-end (cf. SHARK's ``BatchGenerateService`` /
``WorkQueue``): the synchronous :class:`ServingEngine` drive loop runs on a
dedicated background thread, and an asyncio boundary multiplexes any number
of concurrent clients over it.

    client coroutines                     engine thread
    -----------------                     -------------
    await submit(...) --- _Command ---->  submit_request()
    async for tok     <-- call_soon ----  step() -> pump(): per-request
    aclose()/Cancelled -- _Command ---->  cancel(): pages + dense slots
                                          freed, stream ends "cancelled"

Every client holds a :class:`ServiceStream` — an ``AsyncIterator[int]``
backed by its own ``asyncio.Queue``.  The engine thread is the ONLY thread
that touches engine/scheduler/pool state (the thread-safe boundary is the
command queue, not locks inside the engine); it pushes sampled tokens into
the per-client queues via ``loop.call_soon_threadsafe``.

Backpressure is a bounded admission queue: at most ``max_pending``
requests may be in flight (submitted, not yet finished); beyond that
``submit()`` raises :class:`AdmissionRejected` with a reason string rather
than queueing unboundedly — overload surfaces at the caller in O(1), not
as an ever-growing TTFT tail.  WHICH waiting requests the scheduler admits
first (and which it sheds) is the pluggable admission policy's call
(``admission.py``); shed requests end their stream with zero tokens and
``finish_reason == "shed"``.

Token-for-token parity: the service changes *when* requests enter the
scheduler, never the math — a stream's tokens are exactly what
``api.generate()`` returns for the same prompt/params.

On the card, **the engine thread owns every CUDA call.**  It claims the
engine's device when it starts (``torch.cuda.set_device`` and one
synchronize, which orders the weights and arena that the constructing
thread made before the first step here), and every step, graph build,
drain and restore runs on it.  So the first use of each ``(bucket, L)``
step captures its CUDA graph on this thread, and a replay goes to this
thread's current stream, which is also the stream the capture ordered
itself against (``core/hybrid.py::StepGraph``) and the one each step's
logits copy synchronizes.  ``torch.cuda.graph`` captures in ``"global"``
error mode, so no other thread may touch CUDA while a capture runs: the
asyncio side (``submit``, ``check_request``, the admission policies, the
metrics) and the watchdog handle host ints and lists only.  When the loop
ends cleanly the thread drains the queue, so a caller that reads device
state after ``stop()`` sees every step's writes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
import time
from typing import (AsyncIterator, Dict, List, Optional, Sequence, Tuple)

import torch

from repro_torch.serve.engine.api import Completion, completion_of
from repro_torch.serve.engine.engine import ServingEngine
from repro_torch.serve.engine.request import Request, SamplingParams
from repro_torch.serve.service.admission import make_policy
from repro_torch.serve.service.metrics import RequestMetrics, ServiceMetrics


class AdmissionRejected(RuntimeError):
    """Backpressure rejection: the request never entered the engine."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class ServiceError(RuntimeError):
    """The engine thread died (uncaught exception) or was declared hung by
    the watchdog.  Every open :class:`ServiceStream` ends by raising this,
    ``submit()`` after the fact fails fast with it, and ``stop()``
    re-raises it — the failure is delivered everywhere a client could be
    waiting, never swallowed on a background thread."""


def _resolve(loop, fut, value=None, exc=None) -> None:
    """Resolve an asyncio future from the engine/watchdog thread (no-op if
    the awaiting client already went away)."""
    def _set():
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    try:
        loop.call_soon_threadsafe(_set)
    except RuntimeError:
        pass    # loop already closed: the awaiting client is gone


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_pending: int = 64        # in-flight bound (submitted, not finished)
    admission: str = "fifo"      # fifo | deadline | fair_share
    # deadline policy's prefill-time estimate (shed earlier than the bare
    # deadline by this much); ignored by the other policies
    est_ttft_s: float = 0.0
    idle_wait_s: float = 0.002   # engine-thread sleep when no work/commands
    # hung-step detection: a watchdog thread declares the service dead
    # (ServiceError to every client) when ONE engine.step() exceeds this
    # many seconds.  None disables the watchdog.  Size it generously —
    # first-step executable compilation counts against the deadline.
    watchdog_timeout_s: Optional[float] = None
    # per-tenant token-bucket rate limits, ON TOP of whatever admission
    # policy runs inside the scheduler (fair_share arbitrates WHO among
    # admitted requests runs first; the buckets bound how fast each tenant
    # may submit at all).  tenant -> (requests_per_s, burst); tenants
    # absent from the map are unlimited.  A refused submit raises
    # AdmissionRejected(reason="rate_limited") without ever constructing a
    # Request, and is counted by ServiceMetrics per tenant.
    tenant_rate_limits: Optional[Dict[str, Tuple[float, float]]] = None

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1: {self.max_pending}")
        if self.watchdog_timeout_s is not None and self.watchdog_timeout_s <= 0:
            raise ValueError(
                f"watchdog_timeout_s must be > 0: {self.watchdog_timeout_s}")
        for tenant, (rate, burst) in (self.tenant_rate_limits or {}).items():
            if rate <= 0:
                raise ValueError(
                    f"rate for tenant {tenant!r} must be > 0: {rate}")
            if burst < 1:
                raise ValueError(
                    f"burst for tenant {tenant!r} must be >= 1: {burst}")


class _TokenBucket:
    """One tenant's refill bucket: ``burst`` capacity, ``rate`` tokens/s.
    Callers pass the clock in so tests (and the metrics layer) never
    wall-wait for a refill."""

    __slots__ = ("rate", "burst", "level", "t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)       # a fresh tenant gets a full burst
        self.t = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self.level = min(self.burst,
                         self.level + max(0.0, now - self.t) * self.rate)
        self.t = now
        if self.level >= n:
            self.level -= n
            return True
        return False


class ServiceStream:
    """One client's token stream: ``async for tok in stream``.

    Ends via StopAsyncIteration with :attr:`completion` populated
    (``finish_reason`` tells length/stop from shed).  Abandoning the
    stream — ``await stream.aclose()``, or the consuming task being
    cancelled mid-``__anext__`` (client disconnect) — cancels the request
    on the engine thread, freeing its KV pages and dense slots.
    """

    def __init__(self, service: "GenerateService", req: Request):
        self._service = service
        self.request = req
        self.request_id = req.request_id
        self._q: asyncio.Queue = asyncio.Queue()
        self.completion: Optional[Completion] = None
        self._done = False

    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        if self._done:
            raise StopAsyncIteration
        try:
            kind, payload = await self._q.get()
        except asyncio.CancelledError:
            # consuming task cancelled == client disconnected: release the
            # engine-side resources instead of generating headless
            self._disconnect()
            raise
        if kind == "tok":
            return payload
        self._done = True
        if kind == "err":
            raise payload
        self.completion = payload
        raise StopAsyncIteration

    async def aclose(self) -> None:
        """Explicit disconnect (the async analogue of closing
        ``engine.stream()``'s generator)."""
        self._disconnect()

    async def drain(self) -> Tuple[List[int], Completion]:
        """Consume the whole stream; returns (tokens, completion)."""
        toks = [t async for t in self]
        assert self.completion is not None
        return toks, self.completion

    def _disconnect(self) -> None:
        if not self._done and self.completion is None:
            self._service._cancel(self.request_id)

    # engine thread -> client queue (must hop through the loop)
    def _push(self, item) -> None:
        try:
            self._service._loop.call_soon_threadsafe(self._q.put_nowait, item)
        except RuntimeError:
            pass    # loop already closed (e.g. an abandoned wedged thread
            #         finally exiting): nobody is listening anymore


class _StreamState:
    """Engine-thread-side bookkeeping for one live stream."""

    __slots__ = ("handle", "emitted", "tok_times")

    def __init__(self, handle: ServiceStream):
        self.handle = handle
        self.emitted = 0
        self.tok_times: List[float] = []


class GenerateService:
    """Async front-end owning the engine drive loop on a background thread.

    Use as an async context manager (or ``await start()`` / ``stop()``)::

        async with GenerateService(engine, ServiceConfig(...)) as svc:
            stream = await svc.submit(prompt, max_tokens=32,
                                      ttft_deadline_s=0.5)
            async for tok in stream:
                ...
            print(stream.completion.finish_reason, svc.metrics.snapshot())
    """

    def __init__(self, engine: ServingEngine,
                 config: Optional[ServiceConfig] = None, *,
                 policy=None, metrics: Optional[ServiceMetrics] = None):
        self.engine = engine
        self.config = config or ServiceConfig()
        self.metrics = metrics or ServiceMetrics()
        if policy is None:
            kw = {"est_ttft_s": self.config.est_ttft_s} \
                if self.config.admission == "deadline" else {}
            policy = make_policy(self.config.admission, **kw)
        self.policy = policy
        engine.scheduler.admission = policy     # install the scheduler hook
        bind = getattr(policy, "bind", None)
        if bind is not None:
            # policies that model admission cost (deadline) get live
            # telemetry: the metrics prefill EMA + the engine's prefix
            # cache for matched-token discounts
            bind(engine, self.metrics)
        self._cmd: "queue.Queue[Tuple[str, object]]" = queue.Queue()
        self._streams: dict = {}                # engine-thread owned
        # tenant token buckets (loop-side, under their own lock); _now is
        # an attribute so tests can drive the refill clock directly
        self._now = time.monotonic
        self._buckets: Dict[str, _TokenBucket] = {}
        self._bucket_lock = threading.Lock()
        # last-seen speculative EngineStats counters (engine-thread owned):
        # _pump folds the deltas into ServiceMetrics so snapshots track
        # acceptance live, even if the engine stats are reset between runs
        self._spec_seen = (0, 0, 0)
        self._prefix_seen = (0, 0, 0, 0)        # same, for prefix-cache stats
        # in-flight counter crosses threads: incremented at submit (loop
        # side), decremented at finalize (engine side) BEFORE the "end"
        # sentinel is pushed — so when a client sees its stream end, the
        # freed slot is already visible to its next submit()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._error: Optional[BaseException] = None
        self._draining = False           # drain() stops admission first
        # watchdog heartbeat: monotonic stamp while engine.step() runs,
        # None between steps (written by the engine thread, read by the
        # watchdog thread — a single attribute store, no lock needed)
        self._step_started: Optional[float] = None
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_fired = False

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "GenerateService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._run,
                                        name="engine-loop", daemon=True)
        self._thread.start()
        if self.config.watchdog_timeout_s is not None:
            self._watchdog = threading.Thread(target=self._watch,
                                              name="engine-watchdog",
                                              daemon=True)
            self._watchdog.start()
        return self

    async def stop(self) -> None:
        """Stop the engine thread; outstanding streams end 'cancelled'.
        Re-raises the engine/watchdog error when the service died."""
        if self._thread is None:
            return
        self._stop_evt.set()
        self._wake.set()
        loop = asyncio.get_running_loop()
        if self._watchdog_fired:
            # the engine thread may be wedged inside a step forever:
            # bounded join, then abandon the daemon thread — its clients
            # were already failed by the watchdog
            await loop.run_in_executor(None, self._thread.join, 1.0)
        else:
            await loop.run_in_executor(None, self._thread.join)
        if self._watchdog is not None:
            await loop.run_in_executor(None, self._watchdog.join)
            self._watchdog = None
        self._thread = None
        if self._error is not None:
            raise self._error

    async def __aenter__(self) -> "GenerateService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- client face ---------------------------------------------------------

    async def submit(self, prompt: Sequence[int], *,
                     max_tokens: int = 16, temperature: float = 0.0,
                     eos_token_id: Optional[int] = None, seed: int = 0,
                     priority: int = 0, tenant: str = "default",
                     ttft_deadline_s: Optional[float] = None) -> ServiceStream:
        """Submit one request; returns its async token stream.

        Raises :class:`AdmissionRejected` under backpressure (max_pending
        in-flight requests) and ValueError when the request can never fit
        the engine — both surface HERE, before the engine thread is
        involved.  The TTFT/queue-wait clock starts now, so command-queue
        latency is part of the measured service latency.
        """
        if self._thread is None:
            raise RuntimeError("service not started")
        if self._error is not None or not self._thread.is_alive():
            # fail fast instead of enqueueing into a command queue no one
            # will ever service (the client would hang forever)
            raise ServiceError("engine thread is dead") from self._error
        if self._draining:
            self.metrics.on_rejected()
            raise AdmissionRejected("service is draining")
        limits = self.config.tenant_rate_limits
        if limits is not None and tenant in limits:
            with self._bucket_lock:
                b = self._buckets.get(tenant)
                if b is None:
                    rate, burst = limits[tenant]
                    b = self._buckets[tenant] = \
                        _TokenBucket(rate, burst, self._now())
                ok = b.try_take(self._now())
            if not ok:
                self.metrics.on_rate_limited(tenant)
                raise AdmissionRejected("rate_limited")
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
            self.engine.check_request(req)    # pure read: safe off-thread
        except Exception:
            self._finished()                  # invalid: slot never used
            raise
        req.submit_t = time.perf_counter()
        handle = ServiceStream(self, req)
        self.metrics.on_submitted()
        self._send(("submit", handle))
        return handle

    async def drain(self, path: str) -> int:
        """Graceful drain: stop admission, checkpoint every waiting and
        running request's resume record to ``path`` (atomic JSON), end
        their streams with ``finish_reason == "drained"``, and stop the
        service.  Returns the number of requests checkpointed; a fresh
        service over a fresh engine can :meth:`restore` them."""
        if self._thread is None:
            raise RuntimeError("service not started")
        if self._error is not None or not self._thread.is_alive():
            raise ServiceError("engine thread is dead") from self._error
        self._draining = True            # submit() rejects from here on
        fut = asyncio.get_running_loop().create_future()
        self._send(("drain", (path, fut)))
        n = await fut
        await self.stop()
        return n

    async def restore(self, path: str) -> List[ServiceStream]:
        """Resume a drain checkpoint on this (started, fresh) service:
        every checkpointed request is resubmitted mid-generation and gets
        a live :class:`ServiceStream` that yields only its NEW tokens
        (the pre-drain ones are already in ``stream.request.output_tokens``
        and will be part of the final completion)."""
        if self._thread is None:
            raise RuntimeError("service not started")
        if self._error is not None or not self._thread.is_alive():
            raise ServiceError("engine thread is dead") from self._error
        fut = asyncio.get_running_loop().create_future()
        self._send(("restore", (path, fut)))
        return await fut

    def _cancel(self, request_id: str) -> None:
        self._send(("cancel", request_id))

    def _send(self, cmd: Tuple[str, object]) -> None:
        self._cmd.put(cmd)
        self._wake.set()

    def _finished(self) -> None:
        """Free one in-flight slot (engine thread at finalize, or the
        submit() error path).  Runs BEFORE the end-of-stream sentinel so a
        client that saw its stream end can immediately submit again."""
        with self._inflight_lock:
            self._inflight -= 1

    # -- engine thread -------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.engine.device.type == "cuda":
                # the card the arena lives on: plain "cuda" names the
                # constructing thread's current device, not this thread's
                dev = next(t.device for leaves in self.engine.store.arena
                           for t in leaves.values())
                torch.cuda.set_device(dev)
                torch.cuda.synchronize(dev)
            while not self._stop_evt.is_set():
                self._drain_commands()
                progressed = False
                if self.engine.scheduler.has_work:
                    # heartbeat for the watchdog: stamped only while a
                    # step is actually in flight
                    self._step_started = time.monotonic()
                    progressed = self.engine.step()
                    self._step_started = None
                self._pump()
                if not progressed and self._cmd.empty():
                    self._wake.wait(timeout=self.config.idle_wait_s)
                    self._wake.clear()
            self.engine.queue.finish()
        except BaseException as e:          # surface on stop() and streams
            self._error = e
        finally:
            self._shutdown_streams()

    def _watch(self) -> None:
        """Watchdog thread: declare the service dead when one engine step
        overstays ``watchdog_timeout_s``.  The stuck engine thread cannot
        deliver the bad news itself, so the watchdog fails every connected
        stream directly and trips the stop event."""
        t = self.config.watchdog_timeout_s
        while not self._stop_evt.wait(timeout=min(t / 4, 0.05)):
            t0 = self._step_started
            if t0 is not None and time.monotonic() - t0 > t:
                self._watchdog_fired = True
                self._error = ServiceError(
                    f"watchdog: engine step exceeded {t}s deadline")
                for st in list(self._streams.values()):
                    st.handle._push(("err", self._error))
                self._stop_evt.set()
                return

    def _drain_commands(self) -> None:
        while True:
            try:
                op, arg = self._cmd.get_nowait()
            except queue.Empty:
                return
            if op == "submit":
                handle: ServiceStream = arg
                try:
                    self.engine.submit_request(handle.request)
                except BaseException as e:
                    # intake failed AFTER the command left the queue: the
                    # handle is registered nowhere, so deliver the error
                    # here or the client blocks forever
                    self._finished()
                    handle._push(("err", e))
                    raise
                self._streams[handle.request_id] = _StreamState(handle)
            elif op == "cancel":
                self.engine.cancel(arg)     # no-op if already finished
            elif op == "drain":
                path, fut = arg
                try:
                    n = self.engine.drain_to(path)
                    self._pump()    # flush the "drained" completions now
                    _resolve(self._loop, fut, value=n)
                except BaseException as e:
                    _resolve(self._loop, fut, exc=e)
            elif op == "restore":
                path, fut = arg
                try:
                    handles = []
                    for r in self.engine.restore_from(path):
                        handle = ServiceStream(self, r)
                        st = _StreamState(handle)
                        # pre-drain tokens were delivered by the previous
                        # incarnation: stream only the new ones
                        st.emitted = len(r.output_tokens)
                        self._streams[r.request_id] = st
                        with self._inflight_lock:
                            self._inflight += 1
                        self.metrics.on_submitted()
                        handles.append(handle)
                    _resolve(self._loop, fut, value=handles)
                except BaseException as e:
                    _resolve(self._loop, fut, exc=e)

    def _pump(self) -> None:
        """Forward newly sampled tokens to their client queues; finalize
        finished requests (metrics record + end-of-stream sentinel)."""
        es = self.engine.stats
        cur = (es.spec_proposed_tokens, es.spec_accepted_tokens,
               es.spec_rejected_tokens)
        if cur != self._spec_seen:
            seen = self._spec_seen if all(
                c >= s for c, s in zip(cur, self._spec_seen)) else (0, 0, 0)
            self.metrics.on_speculation(cur[0] - seen[0], cur[1] - seen[1],
                                        cur[2] - seen[2])
            self._spec_seen = cur
        pcur = (es.prefix_hits, es.prefix_tokens_reused, es.prefix_evictions,
                es.prompt_tokens_ingested)
        if pcur != self._prefix_seen:
            pseen = self._prefix_seen if all(
                c >= s for c, s in zip(pcur, self._prefix_seen)) \
                else (0, 0, 0, 0)
            self.metrics.on_prefix(pcur[0] - pseen[0], pcur[1] - pseen[1],
                                   pcur[2] - pseen[2], pcur[3] - pseen[3])
            self._prefix_seen = pcur
        now = time.perf_counter()
        done = []
        for rid, st in self._streams.items():
            r = st.handle.request
            while st.emitted < len(r.output_tokens):
                st.tok_times.append(now)
                st.handle._push(("tok", r.output_tokens[st.emitted]))
                st.emitted += 1
            if r.is_finished:
                done.append(rid)
        for rid in done:
            st = self._streams.pop(rid)
            r = st.handle.request
            comp = completion_of(r)
            itl = [b - a for a, b in zip(st.tok_times, st.tok_times[1:])]
            self.metrics.observe(RequestMetrics(
                request_id=r.request_id, tenant=r.tenant,
                priority=r.priority, finish_reason=comp.finish_reason,
                n_tokens=len(comp.tokens), ttft_s=comp.ttft_s,
                queue_wait_s=comp.queue_wait_s, itl_s=itl,
                n_prompt_tokens=len(r.prompt)))
            self._finished()
            st.handle._push(("end", comp))

    def _shutdown_streams(self) -> None:
        """Engine-thread exit: cancel whatever is still live so pages and
        dense slots return to their pools, then flush the final pumps.
        When the thread died with an error, EVERY place a client could be
        blocked gets woken with it: open streams, submits still sitting in
        the command queue (never registered), and pending drain/restore
        futures — nobody hangs on a dead engine."""
        for rid in list(self._streams):
            try:
                self.engine.cancel(rid)     # resources back either way
            except Exception:
                pass
        if self._error is None:
            # clean stop: finalize the cancellations normally
            try:
                self._pump()
            except Exception:
                pass
        else:
            # died: every connected stream ends by RAISING the error (not
            # a quiet "cancelled"), and returns its in-flight slot
            for st in self._streams.values():
                self._finished()
                st.handle._push(("err", self._error))
            self._streams.clear()
        err = self._error or ServiceError("service stopped")
        while True:
            try:
                op, arg = self._cmd.get_nowait()
            except queue.Empty:
                break
            if op == "submit":
                self._finished()            # its in-flight slot, back
                arg._push(("err", err))
            elif op in ("drain", "restore"):
                _resolve(self._loop, arg[1], exc=err)
        # anything STILL unfinished (cancel failed) gets an error sentinel
        for st in self._streams.values():
            st.handle._push(("err", err))
        self._streams.clear()
