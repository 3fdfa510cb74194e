"""The serving engine on a grid of PE processes.

:func:`serve_on_grid` starts ``q * r`` PE processes
(:func:`repro_torch.runtime.pe.run_pes`) and runs :func:`grid_serve_pe` on
each: every PE builds a :class:`~repro_torch.serve.engine.ServingEngine` on
its own blocks of the weights (drawn on its device from a seed, one PE at a
time so that one full tree is on a card at once, or cut from a global
numpy tree), PE 0 serves the prompts (``ServingEngine.drain``; the
controller: scheduler, pool, prefix cache, sampling) while the other
PEs follow its steps (``ServingEngine.follow``), and each PE reports what
it measured.  A run takes several jobs, one engine each, in one spawn of
the grid (the PEs' start-up is paid once).

What a job reports: on PE 0, for each of its ``passes`` over the prompts
(a later pass finds the prompts' pages in the prefix cache), the greedy
tokens, finish reasons, ``EngineStats``, wall and tokens/s, and the logits
rows of the first ``record`` outputs of every request of the first pass;
on every PE its per-step log (step name, wall, collectives, puts, heap
bytes, wait in barriers), its kernels' launch counts over the job, and
with ``profile`` its device busy time over the job, the state commands its
store logged or applied, and the pairs its MoE layers routed and dropped
(the sums of its step log's).

A job's requests arrive all at once, or each at the step and with the
priority ``arrivals`` gives it, under an ``admission`` policy of
:mod:`repro_torch.serve.service.admission` (a priority policy preempts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pe_grid import probe_latency
from repro_torch.kernels import count_delta, launch_counts
from repro_torch.models.params import (from_jax_params, init_params,
                                       shard_params)
from repro_torch.runtime.pe import run_pes
from repro_torch.serve.engine.engine import (EngineConfig, EngineStats,
                                             ServingEngine)
from repro_torch.serve.engine.request import SamplingParams


@dataclasses.dataclass
class GridJob:
    """One engine on the grid and the workload it serves.  ``weights`` is
    a global parameter tree of numpy arrays (``from_jax_params`` takes it),
    else every PE draws the weights from ``seed`` on its device, as a
    one-device engine would, and keeps its blocks."""
    cfg: Any
    engine_cfg: EngineConfig
    prompts: List[List[int]]
    sampling: Any = None              # SamplingParams or one per prompt
    seed: int = 0
    weights: Optional[Dict] = None
    record: int = 0                   # outputs whose logits rows PE 0 keeps
    profile: bool = False             # device busy time per PE
    passes: int = 1                   # times PE 0 serves the prompts
    # (step, priority) of each prompt; None: all at step 0, priority 0
    arrivals: Optional[List[Tuple[int, int]]] = None
    admission: Optional[str] = None   # a policy name; None is fifo


def _kernel_counts(delta) -> Dict[str, int]:
    return {fn.__name__: n for fn, (n, _) in delta.items()}


def _busy_ms(prof) -> Dict[str, float]:
    """Device time of every kernel record of a trace, and their number."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"busy_ms": sum(e.device_time_total for e in kernels) / 1e3,
            "kernel_records": len(kernels)}


def _serve(grid, eng: ServingEngine, job: GridJob) -> Dict[str, Any]:
    if grid.pe != 0:
        return {"steps": eng.follow()}
    rows: Dict[tuple, np.ndarray] = {}
    sample = eng._sample
    index = {}
    record = [job.record]           # the first pass only

    def sampled(req, row):
        k = (index[req.request_id], len(req.output_tokens))
        if k[1] < record[0]:
            rows[k] = row.copy()
        return sample(req, row)

    eng._sample = sampled
    per = job.sampling if isinstance(job.sampling, (list, tuple)) \
        else [job.sampling or SamplingParams()] * len(job.prompts)
    if job.admission is not None:
        from repro_torch.serve.service.admission import make_policy
        eng.scheduler.admission = make_policy(job.admission)
    passes = []
    for k in range(job.passes):
        eng.stats = EngineStats()
        for ev in eng.kernel_events().values():
            ev.first_enqueue_t = ev.last_enqueue_t = ev.last_done_t = 0.0
        first = len(eng.grid_log)
        t0 = time.perf_counter()
        reqs = _drain(eng, job, per, index)
        passes.append({
            "tokens": [list(r.output_tokens) for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "stats": dataclasses.asdict(eng.stats),
            "wall_s": time.perf_counter() - t0,
            "tokens_per_s": eng.throughput_tok_s(),
            "steps": (first, len(eng.grid_log))})
        record[0] = 0
    eng.release_followers()
    return {**passes[0], "passes": passes, "rows": rows,
            "peak_kv_bytes": eng.peak_kv_bytes(),
            "heap_bytes": eng.heap_bytes,
            "heap_slot_bytes": eng.heap_slot_bytes}


def _drain(eng: ServingEngine, job: GridJob, sampling, index) -> list:
    """Serve ``job``'s prompts on PE 0's engine as its ``arrivals`` say;
    ``index`` maps each request's id to its prompt's number.  Returns the
    requests in prompt order."""
    n = len(job.prompts)
    arrivals = job.arrivals or [(0, 0)] * n
    reqs: list = [None] * n

    def submit(k):
        def go():
            reqs[k] = eng.submit(job.prompts[k], sampling[k],
                                 priority=arrivals[k][1])
            index[reqs[k].request_id] = k
        return go
    eng.drain(sorted(((arrivals[k][0], submit(k)) for k in range(n)),
                     key=lambda a: a[0]))
    return reqs


def grid_serve_pe(grid, jobs: Sequence[GridJob], latency: bool = False
                  ) -> List[Dict[str, Any]]:
    """The PE target of :func:`serve_on_grid`: with ``latency`` first the
    parts of one collective timed (:func:`probe_latency`, in the first
    job's report), then each job's engine built on this PE, served (PE 0)
    or followed, and reported."""
    lat = None
    if latency:
        lat = probe_latency(grid)
        grid.close()
    out = []
    for job in jobs:
        params = _pe_params(grid, job)
        eng = ServingEngine(job.cfg, params=params,
                            engine_cfg=job.engine_cfg, seed=job.seed,
                            plan=_plan(grid), grid=grid)
        before = launch_counts()
        prof = None
        if job.profile and grid.device.type == "cuda":
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        res = _serve(grid, eng, job)
        grid.barrier_all()
        res["pe_wall_s"] = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            res.update(_busy_ms(prof))
        res["launches"] = _kernel_counts(count_delta(before,
                                                     launch_counts()))
        res["moe_pairs"] = sum(s["moe_pairs"] for s in eng.grid_log)
        res["moe_dropped"] = sum(s["moe_dropped"] for s in eng.grid_log)
        res["state_commands"] = dict(eng.store.n_commands)
        if lat is not None and not out:
            res["latency_us"] = lat
        res.update(grid_log=eng.grid_log, pe=grid.pe,
                   device=str(grid.device),
                   heap=type(grid.heap).__name__,
                   backend=torch.distributed.get_backend())
        out.append(res)
        del eng, params
        grid.close()                 # the next job's engine sizes its own
        if grid.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _pe_params(grid, job: GridJob):
    return pe_params(grid, job.cfg, seed=job.seed, weights=job.weights)


def pe_params(grid, cfg, *, seed: int = 0, weights: Optional[Dict] = None,
              storage=False):
    """This PE's blocks of a model's weights in ``storage``
    (:func:`~repro_torch.models.params.shard_params`): cut from the global
    numpy tree ``weights``, or drawn on the PE's device from ``seed`` as a
    one-device engine draws them.  The PEs draw in turn, each freeing its
    full tree before the next starts, so the card holds one full tree at a
    time."""
    plan = _plan(grid)
    if weights is not None:
        full = from_jax_params(weights, cfg, device=grid.device)
        return shard_params(full, cfg, plan, grid.pe, storage=storage)
    params = None
    for turn in range(grid.n_pes):
        if turn == grid.pe:
            gen = torch.Generator(device=grid.device).manual_seed(seed)
            full = init_params(cfg, generator=gen, device=grid.device)
            params = shard_params(full, cfg, plan, grid.pe, storage=storage)
            del full, gen
            if grid.device.type == "cuda":
                torch.cuda.empty_cache()
        grid.comm.barrier(f"weights {turn}")
    return params


def _plan(grid):
    from repro_torch.partition import grid_plan
    return grid_plan(grid.q, grid.r)


def serve_on_grid(jobs: Sequence[GridJob], plan, *, device: str = "cuda",
                  timeout: float = 300.0, latency: bool = False
                  ) -> List[List[Dict[str, Any]]]:
    """Serve each job on ``plan``'s grid of PE processes; returns, per
    job, every PE's report in PE order."""
    per_pe = run_pes(grid_serve_pe, plan, args=(list(jobs), latency),
                     device=device, timeout=timeout)
    return [[per_pe[pe][k] for pe in range(plan.n_pes)]
            for k in range(len(jobs))]


def step_shape(name: str):
    """A step's (bucket, length, all_logits) from its name:
    ``serve_step_bs{N}``, ``prefill_bs{N}_len{L}``, ``verify_bs{N}_len{L}``."""
    bucket = int(name.split("_bs")[1].split("_")[0])
    length = int(name.split("_len")[1]) if "_len" in name else 1
    return bucket, length, name.startswith("verify")


def pe_heads(cfg, plan):
    """(q heads, kv heads) a PE holds on ``plan``'s grid, as the JAX grid
    stores them; (0, 0) for a model with no attention layer."""
    if not any(m == "attn" for m, _ in cfg.pattern()):
        return 0, 0
    r = plan.grid_r
    return cfg.heads_padded(r) // r, cfg.kv_stored(r)[0] // r


def reckoned_heap_bytes(cfg, plan, name: str, hq: int, kvh: int) -> int:
    """The heap bytes a step puts over all PEs, reckoned from the shapes
    alone (:func:`repro_torch.serve.decode.grid_messages`); ``hq``/``kvh``
    are a PE's heads."""
    from repro_torch.serve.decode import grid_messages
    bucket, length, every = step_shape(name)
    return plan.n_pes * sum(
        m.nbytes * m.puts for m in grid_messages(
            cfg, plan, bucket, length, hq=hq, kvh=kvh, all_logits=every))


def heap_bytes_by_step(reports: List[Dict[str, Any]]) -> List[int]:
    """The heap bytes every PE put in each step of a job, summed over the
    PEs (every PE logs the same steps in the same order)."""
    logs = [r["grid_log"] for r in reports]
    return [sum(log[k]["heap_bytes"] for log in logs)
            for k in range(len(logs[0]))]
