"""Serving launcher, on the card: fixed-batch greedy decoding, or a
mixed-length workload through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --mode gemv --batch 8 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --engine --requests 8 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --service --admission deadline
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --supervised --kills 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --engine --grid 2x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --engine --grid 2x2
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-235b-a22b --layers 2 --engine --grid 2x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --mode batched --grid 2x2

serves the full-width model on ``cuda`` with random weights from seed 0.
``--smoke`` takes the ``reduced()`` config instead (as the JAX launcher
always does); ``--device cpu`` runs the plain PyTorch versions of every
kernel on the CPU.

Without ``--engine``, ``--service`` or ``--supervised`` (the JAX
launcher's default) it decodes one fixed batch: ``--batch`` sequences from
random first tokens, ``--tokens`` greedy steps of
``serve/decode.py::make_decode_step`` in ``--mode`` (``gemv`` by default,
``batched`` or ``longctx``: on one card the three compute the same
function) over a contiguous cache of ``--s-max`` positions, and prints the
wall per token, synchronised with the card, beside the card's name.
Attention layers attend over the cache, mamba layers run the one-token
recurrence, MoE layers run their experts on the grouped GEMM.  whisper-base
is refused here, as the JAX launcher refuses it: its decoder needs an
encoder pass to fill the cross-K/V cache
(``serve/decode.py::fill_cross_cache``, as ``chip_smoke.py``'s ``encdec``
phase does).  ``--mode batched --grid QxR`` decodes the fixed batch on a
``q x r`` grid of PE processes instead (``launch/grid_run.py``; the JAX
launcher's batched mode, ``repro/launch/serve.py:117-141``): the batch over
the grid rows, Cannon projections on pre-skewed weight blocks, each PE's
cache its own; it prints the tokens, the wall, collectives and barrier
wait a step and the heap bytes against the count reckoned from the
shapes.  ``gemv`` and ``longctx`` on a grid come with a later slice.

With ``--engine`` attention layers page their K/V, mamba layers keep dense
state slots and MoE layers run the grouped GEMM; ``--speculation ngram``
(or ``draft_model``, which self-drafts with the reduced target config and
so needs ``--smoke``) verifies up to ``--spec-k`` draft tokens per slot in
one ``verify_bs{N}_len{k+1}`` launch.  pixtral-12b's text is served there
too (its ``vis_proj`` unused), whisper-base is not: the engine keeps no
cross caches.  ``--engine --grid QxR`` serves the same workload on a
``q x r`` grid of PE processes (``serve/engine/grid.py``; spawned, PE p on
card ``p % device_count``, on the CPU with ``--device cpu``): PE 0
schedules and samples, every PE runs each step body on its blocks of the
weights, and the collectives put through the symmetric heap.  Every
decoder family serves there: mamba layers keep their columns' channels and
heads in each PE's dense slots, MoE layers exchange tokens with the
experts' owner PEs.  It prints the heap's size, the steps' collectives,
barrier wait and heap bytes against the count reckoned from the shapes,
tokens/s, the state commands PE 0 sent and the MoE pairs dropped at the
config's capacity factor.  ``--layers N`` cuts the model to its first N
layers (a multiple of its pattern), as a full MoE config needs on one
card.

With ``--service`` the same workload arrives instead through the asyncio
``GenerateService`` front-end: concurrent streaming clients at Poisson
arrivals of ``--rate`` requests/s over one engine thread, admitted by
``--admission fifo|deadline|fair_share`` (``--ttft-slo`` gives every
request a TTFT deadline, which ``deadline`` sheds on), and the run ends by
printing the ``ServiceMetrics`` snapshot (p50/p99 TTFT, inter-token and
queue-wait latencies, shed and reject counters).

With ``--supervised`` the workload goes through the crash-safe
``ReplicaSupervisor``: the engine drive loop runs in a spawned worker
process (on the card by default, on the CPU with ``--device cpu``) that
takes a drain checkpoint every 4 steps, and ``--kills`` hard-kills it
mid-generation, evenly over the workload's tokens; each time a fresh
worker restores the last good checkpoint and the streams resume.  The run
ends by printing the supervised metrics snapshot (restarts, checkpoints,
recovery seconds) and each failover's times.

Before it allocates, the launcher reckons the weights' bytes from the
config and raises, naming the device's memory, when they do not fit: the
full MoE configs do not fit one H100 (qwen3-moe-235b-a22b's 94 layers hold
464 GB of bf16 weights; chip_smoke.py serves it at 8 layers, 41.7 GB).  It
never cuts depth on its own; ``--smoke`` is the way to a small model.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.params import config_param_bytes, init_params
from repro_torch.serve.decode import cache_specs, make_decode_step
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)
from repro_torch.serve.spec import SpeculationConfig


def _engine_cfg(args) -> EngineConfig:
    stride = 16
    s_max = -(-max(args.s_max, args.tokens + 12) // stride) * stride
    buckets = tuple(b for b in (1, 2, 4, 8) if b <= max(args.batch, 1))
    chunks = tuple(int(c) for c in args.prefill_chunks.split(",") if c)
    speculation = None
    if args.speculation != "off":
        speculation = SpeculationConfig(
            drafter=args.speculation, k=args.spec_k,
            # self-drafting: the reduced target config itself runs on the
            # draft queue (vocabs match by construction)
            draft_config=args.arch if args.speculation == "draft_model"
            else None)
    return EngineConfig(s_max=s_max, buckets=buckets,
                        block_pos_stride=stride, prefill_chunks=chunks,
                        prefix_cache=args.prefix_cache != "off",
                        device=args.device, speculation=speculation)


def _workload(cfg, args):
    rng = np.random.default_rng(0)
    vocab = min(cfg.vocab_size, 256)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 12))).tolist()
            for _ in range(args.requests)]


# share of the device's memory the weights may take; the rest holds the KV
# arena, the dense slots, the step graphs' pools and the activations
FIT_SHARE = 0.9


def check_fit(cfg, device) -> int:
    """The bytes of ``cfg``'s weights, reckoned from the config; raises
    ``MemoryError`` naming the device's memory when they take more than
    ``FIT_SHARE`` of it."""
    need = config_param_bytes(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        have, where = props.total_memory, f"{props.name}'s"
    else:
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = "the host's"
    if need > FIT_SHARE * have:
        raise MemoryError(
            f"{cfg.name} at {cfg.n_layers} layers needs {need / 1e9:.1f} GB "
            f"of weights, more than {FIT_SHARE:.0%} of {where} "
            f"{have / 1e9:.1f} GB: serve the reduced config (--smoke)")
    return need


def _build(cfg, args):
    """The engine, once the weights are known to fit."""
    need = check_fit(cfg, args.device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{need / 1e9:.2f} GB of weights")
    return build_engine(cfg, seed=0, engine_cfg=_engine_cfg(args))


def _main_engine(cfg, args):
    eng = _build(cfg, args)
    prompts = _workload(cfg, args)
    outs = generate(eng, prompts, SamplingParams(max_tokens=args.tokens))
    for c in outs[:4]:
        print(f"  {c.request_id}: prompt[{len(c.prompt)}] -> "
              f"{c.tokens[:12]} ({c.finish_reason})")
    ev = eng.kernel_events()
    st = eng.stats
    ttfts = [c.ttft_s for c in outs if c.ttft_s is not None]
    kinds = " + ".join(k for k, on in (
        ("paged KV", eng.store.needs_pages),
        ("dense slots", eng.store.has_dense)) if on)
    print(f"served {len(outs)} requests / {st.tokens_generated} tokens "
          f"({cfg.family}: {kinds}, {eng.device}): "
          f"{eng.throughput_tok_s():.1f} tok/s over {len(ev)} executables "
          f"{sorted(ev)}")
    ttft_ms = f"{np.mean(ttfts) * 1e3:.1f} ms" if ttfts else "n/a"
    tpl = st.tokens_generated / max(st.launches, 1)
    print(f"  prefill: {st.prompt_tokens_ingested} prompt tokens ingested "
          f"in {st.prefill_launches} launches "
          f"({st.prefill_chunk_launches} chunked); "
          f"decode: {st.decode_launches} launches; "
          f"{tpl:.2f} tokens/launch; mean TTFT {ttft_ms}")
    if st.spec_launches:
        print(f"  speculation: {st.spec_launches} verify launches, "
              f"{st.spec_proposed_tokens} proposed / "
              f"{st.spec_accepted_tokens} accepted "
              f"(accept rate {st.spec_accept_rate:.2f}, "
              f"{st.spec_rollbacks} rollbacks)")
    if eng.store.has_dense:
        print(f"  dense slots: peak {st.peak_dense_slots_used} of "
              f"{eng.store.slot_pool.n_slots} "
              f"({eng.store.dense_slot_bytes} bytes each)")
    if st.prefix_hits or st.prefix_evictions:
        print(f"  prefix cache: {st.prefix_hits} page hits, "
              f"{st.prefix_tokens_reused} prompt tokens reused "
              f"(hit rate {st.prefix_hit_rate:.2f}), "
              f"{st.prefix_evictions} evictions")


def _main_grid(cfg, args):
    """The engine's workload on a grid of PE processes."""
    from repro_torch.partition import parse_grid
    from repro_torch.serve.engine.grid import (GridJob, heap_bytes_by_step,
                                               pe_heads, reckoned_heap_bytes,
                                               serve_on_grid)
    plan = parse_grid(args.grid)
    device = args.device or "cuda"
    need = check_fit(cfg, device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{need / 1e9:.2f} GB of weights, on a {plan.grid_q}x"
          f"{plan.grid_r} grid of PE processes ({device})")
    prompts = _workload(cfg, args)
    job = GridJob(cfg, _engine_cfg(args), prompts,
                  SamplingParams(max_tokens=args.tokens), seed=0)
    reports = serve_on_grid([job], plan, device=device)[0]
    pe0 = reports[0]
    for n, toks in enumerate(pe0["tokens"][:4]):
        print(f"  req {n}: prompt[{len(prompts[n])}] -> {toks[:12]} "
              f"({pe0['finish'][n]})")
    log = pe0["grid_log"]
    hq, kvh = pe_heads(cfg, plan)
    got = heap_bytes_by_step(reports)
    want = [reckoned_heap_bytes(cfg, plan, s["name"], hq, kvh) for s in log]
    wall = sum(s["wall_s"] for s in log)
    print(f"heap: {pe0['heap_bytes']} bytes a PE (slots of "
          f"{pe0['heap_slot_bytes']} bytes)")
    print(f"served {len(prompts)} requests / "
          f"{pe0['stats']['tokens_generated']} tokens in {len(log)} steps: "
          f"{pe0['tokens_per_s']:.1f} tok/s, "
          f"{1e3 * wall / max(len(log), 1):.1f} ms a step, "
          f"{sum(s['collectives'] for s in log) / max(len(log), 1):.0f} "
          f"collectives a step, barrier wait "
          f"{sum(s['wait_s'] for s in log) / max(wall, 1e-9):.0%} of "
          f"PE 0's step wall")
    print(f"heap bytes over all PEs: {sum(got)} put, {sum(want)} reckoned "
          f"from the shapes ({'equal' if got == want else 'DIFFERENT'})")
    if pe0["state_commands"]:
        print(f"dense slot commands PE 0 sent: {pe0['state_commands']}")
    if pe0["moe_pairs"]:
        print(f"MoE: {pe0['moe_dropped']} of {pe0['moe_pairs']} routed pairs "
              f"dropped at capacity_factor {cfg.capacity_factor}")
    if got != want:
        raise SystemExit("heap traffic differs from the reckoned count")


def _main_fixed(cfg, args):
    """The fixed batch: greedy tokens from random first ones, the wall per
    token on the device (synchronised), the first sequences."""
    import time
    if cfg.enc_layers:
        raise SystemExit("whisper serving needs an encoder pass; see "
                         "chip_smoke.py's encdec phase for the full harness "
                         "(serve/decode.py::fill_cross_cache)")
    need = check_fit(cfg, args.device)
    dev = resolve_device(args.device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{need / 1e9:.2f} GB of weights")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    step = make_decode_step(cfg, batch=args.batch, s_max=args.s_max,
                            mode=args.mode)
    cache = cache_specs(cfg, args.batch, args.s_max, args.mode, device=dev)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, min(cfg.vocab_size, 256),
                                        size=(args.batch,)).astype(np.int32)
                           ).to(dev)
    out_tokens = [tok]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for t in range(args.tokens):
        logits = step(params, cache, tok, t)
        tok = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1).to(
            torch.int32)
        out_tokens.append(tok)
    sync()
    dt = (time.perf_counter() - t0) / max(args.tokens, 1)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "the CPU (plain versions)"
    seqs = torch.stack(out_tokens, 1).cpu().numpy()
    print(f"decoded {args.tokens} tokens x batch {args.batch} "
          f"({args.mode}, s_max {args.s_max}): {dt * 1e3:.2f} ms/token on "
          f"{where}")
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {seqs[b][:16].tolist()} ...")


def _main_fixed_grid(cfg, args):
    """The fixed batch on a grid of PE processes (``--mode batched``)."""
    from repro_torch.launch.grid_run import DecodeJob, run_on_grid
    from repro_torch.partition import parse_grid
    if args.mode != "batched":
        raise SystemExit(f"--mode {args.mode} on a grid of PE processes "
                         f"comes with a later slice (gemv/longctx "
                         f"fixed-batch on the grid); use --mode batched")
    if cfg.enc_layers:
        raise SystemExit("encoder-decoder models on a grid of PE processes "
                         "come with a later slice")
    plan = parse_grid(args.grid)
    device = args.device or "cuda"
    need = check_fit(cfg, device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{need / 1e9:.2f} GB of weights, batched decode on a "
          f"{plan.grid_q}x{plan.grid_r} grid of PE processes ({device})")
    first = np.random.default_rng(0).integers(0, min(cfg.vocab_size, 256),
                                              size=(args.batch,))
    job = DecodeJob(cfg, first, s_max=max(args.s_max, args.tokens),
                    steps=args.tokens)
    reports = run_on_grid([job], plan, device=device)[0]
    pe0 = reports[0]
    steps = pe0["steps"]
    wall = sum(s["wall_s"] for s in steps)
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {pe0['tokens'][b][:16].tolist()} ...")
    got = [sum(r["steps"][k]["heap_bytes"] for r in reports)
           for k in range(len(steps))]
    want = plan.n_pes * pe0["reckoned_heap_bytes"]
    same = all(np.array_equal(r["tokens"], pe0["tokens"]) for r in reports)
    print(f"decoded {args.tokens} tokens x batch {args.batch}: "
          f"{1e3 * wall / max(len(steps), 1):.2f} ms a step, "
          f"{steps[0]['collectives']} collectives a step, barrier wait "
          f"{sum(s['wait_s'] for s in steps) / max(wall, 1e-9):.0%} of "
          f"PE 0's wall; every PE's tokens {'equal' if same else 'DIFFER'}")
    print(f"heap bytes a step over all PEs: {got[0]} put, {want} reckoned "
          f"from the shapes ({'equal' if set(got) == {want} else 'DIFFERENT'}"
          f"; slots of {pe0['heap_slot_bytes']} bytes)")
    if set(got) != {want} or not same:
        raise SystemExit("the grid's decode differs from its reckoning")


def _main_service(cfg, args):
    import asyncio
    import json

    from repro_torch.serve.service import (AdmissionRejected,
                                           GenerateService, ServiceConfig)
    eng = _build(cfg, args)
    prompts = _workload(cfg, args)
    gaps = np.random.default_rng(1).exponential(1.0 / args.rate,
                                                size=args.requests)

    async def client(svc, prompt):
        try:
            stream = await svc.submit(prompt, max_tokens=args.tokens,
                                      ttft_deadline_s=args.ttft_slo)
        except AdmissionRejected as e:
            print(f"  rejected: {e.reason}")
            return None
        toks, comp = await stream.drain()
        return comp

    async def drive():
        svc_cfg = ServiceConfig(admission=args.admission)
        async with GenerateService(eng, svc_cfg) as svc:
            tasks = []
            for prompt, gap in zip(prompts, gaps):
                await asyncio.sleep(gap)    # open loop: Poisson arrivals
                tasks.append(asyncio.create_task(client(svc, prompt)))
            comps = await asyncio.gather(*tasks)
            return comps, svc.metrics.snapshot()

    comps, snap = asyncio.run(drive())
    for c in [c for c in comps if c is not None][:4]:
        print(f"  {c.request_id}: prompt[{len(c.prompt)}] -> "
              f"{c.tokens[:12]} ({c.finish_reason})")
    print(f"service ({args.admission} admission, rate {args.rate:g}/s, "
          f"{eng.device}): {snap['completed']} completed, {snap['shed']} "
          f"shed, {snap['rejected']} rejected, {snap['tokens']} tokens in "
          f"{eng.stats.launches} launches")
    print(json.dumps(snap, indent=2))


def _main_supervised(cfg, args):
    import asyncio
    import json
    import tempfile

    from repro_torch.serve.supervisor import (EngineSpec, ReplicaSupervisor,
                                              SupervisorConfig)
    need = check_fit(cfg, args.device)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{need / 1e9:.2f} GB of weights, served by a spawned worker")
    spec = EngineSpec(model_cfg=cfg, engine_cfg=_engine_cfg(args), seed=0)
    prompts = _workload(cfg, args)
    ckpt_dir = tempfile.mkdtemp(prefix="serve-supervised-")
    sup_cfg = SupervisorConfig(
        checkpoint_path=os.path.join(ckpt_dir, "replica.ckpt"),
        checkpoint_every_steps=4, max_respawns=args.kills + 2)
    total = args.tokens * len(prompts)
    thresholds = [total * (i + 1) // (args.kills + 1)
                  for i in range(max(0, args.kills))]

    async def drive():
        async with ReplicaSupervisor(spec, sup_cfg) as sup:
            streams = [await sup.submit(p, max_tokens=args.tokens)
                       for p in prompts]
            delivered = {s.request_id: 0 for s in streams}
            comps = {}

            async def consume(s):
                async for _ in s:
                    delivered[s.request_id] += 1
                comps[s.request_id] = s.completion

            tasks = [asyncio.create_task(consume(s)) for s in streams]

            async def killer():
                for i, threshold in enumerate(thresholds):
                    while sum(delivered.values()) < threshold:
                        await asyncio.sleep(0.01)
                    print(f"  SIGKILL worker #{i + 1} "
                          f"({sum(delivered.values())} tokens delivered)")
                    await sup.kill_replica()
                    while sup.n_spawns < i + 2:
                        await asyncio.sleep(0.05)

            await asyncio.gather(killer(), *tasks)
            return ([comps[s.request_id] for s in streams],
                    sup.metrics.snapshot(), sup.n_failovers, sup.failovers)

    comps, snap, n_failovers, failovers = asyncio.run(drive())
    for c in [c for c in comps if c is not None][:4]:
        print(f"  {c.request_id}: prompt[{len(c.prompt)}] -> "
              f"{c.tokens[:12]} ({c.finish_reason})")
    for i, rec in enumerate(failovers):
        inc, t0 = rec.get("incarnation", {}), rec["t_detect"]
        line = (f"  failover #{i + 1} ({rec['reason']}): reaped after "
                f"{rec['t_exit'] - t0:.2f}s")
        if inc:
            line += (f", next worker ready {inc['t_ready'] - t0:.2f}s after "
                     f"detection (build {inc['build_s']:.2f}s)")
        if "t_first_token" in rec:
            line += (f", first resumed token at "
                     f"{rec['t_first_token'] - t0:.2f}s")
        print(line)
    fo = snap["failover"]
    rec = fo["recovery_s"]["mean"]
    print(f"supervised replica: {snap['completed']} completed / "
          f"{snap['tokens']} tokens across {n_failovers} failovers "
          f"({fo['checkpoints']} checkpoints"
          + (f", mean recovery {rec:.2f}s" if rec is not None else "")
          + ") — streams resumed with zero duplicated/dropped tokens")
    print(json.dumps(snap, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--config", dest="arch", required=True,
                    type=lambda s: s.replace("_", "-"),
                    choices=list(ARCH_NAMES))
    ap.add_argument("--engine", action="store_true",
                    help="serve a mixed-length workload through the "
                         "continuous-batching engine")
    ap.add_argument("--service", action="store_true",
                    help="serve it through the asyncio GenerateService "
                         "front-end (concurrent streaming clients, "
                         "SLO-aware admission) and print its metrics "
                         "snapshot")
    ap.add_argument("--supervised", action="store_true",
                    help="serve through the crash-safe ReplicaSupervisor: "
                         "the engine drive loop runs in a spawned worker "
                         "process taking periodic drain checkpoints, and "
                         "--kills hard-kills it mid-generation to "
                         "demonstrate failover with no token lost")
    ap.add_argument("--kills", type=int, default=1,
                    help="worker kills to inject under --supervised")
    ap.add_argument("--admission", default="fifo",
                    choices=["fifo", "deadline", "fair_share"],
                    help="admission policy for --service")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate (req/s) for --service")
    ap.add_argument("--ttft-slo", type=float, default=None, dest="ttft_slo",
                    help="per-request TTFT deadline in seconds for "
                         "--service (sheds infeasible requests under "
                         "--admission deadline)")
    ap.add_argument("--mode", default="gemv",
                    choices=["batched", "gemv", "longctx"],
                    help="the fixed-batch decode layout (the default path; "
                         "one function on one card)")
    ap.add_argument("--batch", type=int, default=8,
                    help="the fixed batch, or the largest batch bucket")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8,
                    help="workload size for --engine / --service")
    ap.add_argument("--prefill-chunks", default="16,64,256",
                    help="chunked-prefill length ladder (comma-separated; "
                         "empty string disables chunking)")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"])
    ap.add_argument("--speculation", default="off",
                    choices=["off", "ngram", "draft_model"],
                    help="speculative decoding: draft k tokens per slot "
                         "(prompt-lookup, or the reduced config on a second "
                         "CommandQueue) and verify them in one "
                         "verify_bs{N}_len{k+1} launch")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per slot per verify launch")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config instead of full width")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers only (a multiple of the "
                         "layer pattern)")
    ap.add_argument("--grid", default=None,
                    help="with --engine, or the fixed batch with --mode "
                         "batched: serve on a QxR grid of PE processes "
                         "(e.g. 2x2)")
    args = ap.parse_args(argv)
    if args.speculation == "draft_model" and not args.smoke:
        ap.error("--speculation draft_model self-drafts with the reduced "
                 "config, whose vocab only the reduced target shares: add "
                 "--smoke")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.layers is not None:
        if args.layers % len(cfg.pattern()):
            ap.error(f"--layers must be a multiple of {cfg.name}'s "
                     f"{len(cfg.pattern())}-layer pattern")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.grid and (args.service or args.supervised):
        ap.error(f"--{'supervised' if args.supervised else 'service'} on a "
                 f"grid of PE processes comes with ROADMAP section 1 item 5 "
                 f"(speculation, the service, resilience and the supervisor "
                 f"at q*r > 1); drop --grid {args.grid}")
    if (args.engine or args.service or args.supervised) \
            and args.mode != "gemv":
        print(f"note: the engine serves through its per-slot paged step; "
              f"--mode {args.mode} ignored")
    if args.supervised:
        _main_supervised(cfg, args)
    elif args.service:
        _main_service(cfg, args)
    elif args.engine and args.grid:
        _main_grid(cfg, args)
    elif args.engine:
        _main_engine(cfg, args)
    elif args.grid:
        _main_fixed_grid(cfg, args)
    else:
        _main_fixed(cfg, args)


if __name__ == "__main__":
    main()
