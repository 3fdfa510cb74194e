"""Replica worker: the ServingEngine drive loop in a child process
(``repro.serve.supervisor.worker`` over the port's engine).

``worker_main`` is the module-level ``multiprocessing`` spawn entry.  It
rebuilds the engine from an
:class:`~repro_torch.serve.supervisor.spec.EngineSpec` and then runs the
same drain-commands / step / pump cycle the in-process ``GenerateService``
engine thread runs, but with the command queue and the token push replaced
by a pair of pipes to the supervisor:

    parent -> worker (cmd pipe)          worker -> parent (evt pipe)
    ("submit", record)                   ("ready", info)   after build
    ("cancel", request_id)               ("tok", rid, start, [tokens])
    ("stats", )                          ("fin", rid, Completion)
    ("kill", )   hard-exit NOW           ("ckpt", n_requests, corrupted)
    ("stop", )   clean exit              ("hb", busy_s, steps_done)
                                         ("stats", dict) / ("bye",)
                                         ("subfail", rid, exc) / ("err", s)

Submits arrive as drain-checkpoint *records* (:func:`request_record`
shape): one wire format for fresh requests (empty outputs), restored
requests (outputs + rng state replayed from the last good checkpoint) and
the supervisor's post-crash re-submissions.  Token events carry the
ABSOLUTE output index of their first token, so the parent can deduplicate
a re-execution's replayed tokens against each stream's high-water mark.
``ready`` carries what the worker measured of its own start: the wall
clock when ``worker_main`` was entered (the interpreter's start and the
imports that unpickling this function pulls in, torch's among them, lie
before it), the seconds its engine build took, and the card's free memory
when it was ready.

Ordering contract the failover parity proof needs: each loop iteration
steps, THEN pumps token events, THEN (on cadence) checkpoints, so every
token a checkpoint knows about was already on the event pipe when the
checkpoint hit disk.  Pipe writes are kernel-buffered, so they survive the
injected ``process_kill`` hard exit (``os._exit``, a stand-in SIGKILL)
checked at the top of the next iteration.

On the card the main thread owns every CUDA call: it claims the engine's
card (``torch.cuda.set_device``) before it builds, and every step (the
first of each ``(bucket, L)`` captures its CUDA graph), checkpoint and
stats read runs on it.  The heartbeat runs on a side thread, touches no
tensor, and reports how long the CURRENT step has been in flight (0.0 when
idle), which is what lets the supervisor's watchdog distinguish a wedged
step from a merely busy worker while the main thread is stuck inside the
step and cannot report anything.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Supervisor-chosen knobs, pickled to the worker at spawn."""

    checkpoint_path: str
    checkpoint_every_steps: int = 8   # cadence, in committed engine steps
    fsync: bool = True                # durability vs. test latency
    idle_wait_s: float = 0.002        # cmd-pipe poll timeout when idle
    heartbeat_s: float = 0.02         # side-thread hb cadence

    def __post_init__(self):
        if self.checkpoint_every_steps < 1:
            raise ValueError(f"checkpoint_every_steps must be >= 1: "
                             f"{self.checkpoint_every_steps}")


def _kernel_counts() -> dict:
    """Every counted kernel wrapper's and plain version's launches in this
    process, by function name (the plain versions end in ``_ref``)."""
    from repro_torch.kernels import COUNTED
    return {fn.__name__: fn.launches for fn in COUNTED}


def _kernel_builds() -> dict:
    """library -> whether this process compiled it (False: it loaded the
    library an earlier build left under build/repro_torch/)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        info = getattr(mod, "build_info", None)
        if name.startswith("repro_torch.kernels.") and info:
            out[name.split(".")[2]] = bool(info.get("built"))
    return out


def _leak_stats(engine, live) -> dict:
    """Resource-accounting snapshot the supervisor's tests assert on (zero
    leaked pages/slots after the final restore), with this incarnation's
    step replays and kernel launches."""
    out = {
        "pool_blocks": engine.pool.n_blocks,
        "pool_free": engine.pool.n_free,
        "dense_slots_used": (engine.store.slot_pool.n_used
                             if engine.store.slot_pool is not None else 0),
        "live_requests": len(live),
        "steps": engine.stats.steps,
        "tokens_generated": engine.stats.tokens_generated,
        "step_launches": {n: ev.launches
                          for n, ev in engine.kernel_events().items()},
        "graph_build_s": sum(ev.build_time_s
                             for ev in engine.kernel_events().values()),
        "kernel_launches": _kernel_counts(),
        "kernel_builds": _kernel_builds(),
    }
    inj = engine.engine_cfg.fault_injector
    if inj is not None:
        out["faults"] = inj.counts()
    return out


def worker_main(spec, cmd, evt, wcfg: WorkerConfig) -> None:
    """Spawn entry: build the replica engine and drive it until told to
    stop (or killed).  ``cmd``/``evt`` are the parent's pipe ends."""
    t_enter = time.time()
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.serve.engine.api import completion_of
    from repro_torch.serve.resilience.checkpoint import thaw_request

    dev = resolve_device(spec.engine_cfg.device)
    if dev.type == "cuda":
        # plain "cuda" names this process's current card
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    t0 = time.perf_counter()
    engine = spec.build()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    inj = engine.engine_cfg.fault_injector

    send_lock = threading.Lock()        # main loop + heartbeat thread

    def _send(item) -> None:
        with send_lock:
            try:
                evt.send(item)
            except (BrokenPipeError, OSError):
                pass                    # parent gone: nothing left to tell

    state = {"step_started": None, "steps_done": 0, "stop": False}

    def _beat() -> None:
        while not state["stop"]:
            t0 = state["step_started"]
            busy = 0.0 if t0 is None else time.monotonic() - t0
            _send(("hb", busy, state["steps_done"]))
            time.sleep(wcfg.heartbeat_s)

    threading.Thread(target=_beat, name="replica-heartbeat",
                     daemon=True).start()
    _send(("ready", {
        "pid": os.getpid(), "t_enter": t_enter, "build_s": build_s,
        "device": str(dev),
        "mem_free": (torch.cuda.mem_get_info()[0] if dev.type == "cuda"
                     else None)}))

    live: dict = {}                     # request_id -> Request
    reported: dict = {}                 # request_id -> tokens sent (absolute)
    steps_since_ckpt = 0

    def _pump() -> None:
        done = []
        for rid, req in live.items():
            n = len(req.output_tokens)
            if n > reported[rid]:
                _send(("tok", rid, reported[rid],
                       list(req.output_tokens[reported[rid]:])))
                reported[rid] = n
            if req.is_finished:
                done.append(rid)
        for rid in done:
            req = live.pop(rid)
            reported.pop(rid)
            _send(("fin", rid, completion_of(req)))

    def _checkpoint() -> None:
        n = engine.checkpoint_to(wcfg.checkpoint_path, fsync=wcfg.fsync)
        corrupted = inj is not None and inj.corrupt_checkpoint()
        if corrupted:
            # injected bit rot: chop the durable file's tail so a restore
            # must detect the truncation and fall back to previous-good
            with open(wcfg.checkpoint_path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(wcfg.checkpoint_path) // 2))
        _send(("ckpt", n, corrupted))

    try:
        while True:
            timeout = 0.0 if engine.scheduler.has_work else wcfg.idle_wait_s
            while cmd.poll(timeout):
                timeout = 0.0
                op, arg = cmd.recv()
                if op == "submit":
                    req, rng_state = thaw_request(arg)
                    try:
                        engine.submit_request(req)
                    except Exception as e:
                        _send(("subfail", req.request_id, e))
                        continue
                    if rng_state is not None:
                        rng = np.random.default_rng()
                        rng.bit_generator.state = rng_state
                        engine._rngs[req.request_id] = rng
                    live[req.request_id] = req
                    # restored records carry pre-crash outputs the parent
                    # already delivered: report only the continuation,
                    # with absolute indices picking up where they end
                    reported[req.request_id] = len(req.output_tokens)
                elif op == "cancel":
                    engine.cancel(arg)
                elif op == "stats":
                    _send(("stats", _leak_stats(engine, live)))
                elif op == "kill":
                    os._exit(1)         # supervisor-driven SIGKILL stand-in
                elif op == "stop":
                    engine.queue.finish()
                    state["stop"] = True
                    _send(("bye",))
                    return
            # injected hard death: consulted once per step-with-work so
            # the schedule is a pure function of the injector seed and the
            # workload, and only AFTER the previous step's tokens were
            # pumped (the pipe outlives os._exit)
            if engine.scheduler.has_work:
                if inj is not None and inj.kill_process():
                    os._exit(1)
                state["step_started"] = time.monotonic()
                engine.step()
                state["step_started"] = None
                state["steps_done"] += 1
                _pump()
                steps_since_ckpt += 1
                if steps_since_ckpt >= wcfg.checkpoint_every_steps:
                    _checkpoint()
                    steps_since_ckpt = 0
    except BaseException as e:          # noqa: BLE001 — report, then die
        state["stop"] = True
        _send(("err", repr(e)))
        raise
