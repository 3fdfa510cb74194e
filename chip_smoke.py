#!/usr/bin/env python3
"""Chip smoke test: repro_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — compile the CUDA paged-attention kernel from the checkout's
   sources with nvcc for sm_90a;
3. kernel against its plain version on the card — random scrambled block
   tables with holes, qwen2-0.5b head geometry (14 q heads over 2 kv heads,
   hd 64, stride 16), B in {1, 8}, L in {1, 16, 64, 256}, bf16 and fp32
   arenas, contexts up to 512, plus hd 8 with two grid rows sharing the
   pages; then timings at the main path's shapes against the plain
   version, one scaled_dot_product_attention call on the gathered K/V, and
   the least time the card could take;
4. end-to-end reference check — the reduced qwen2 config in fp32, served
   on the card and on the CPU (plain versions) from the same weights;
5. the engine at full width — qwen2-0.5b (24 layers, d_model 896, vocab
   151936, bf16) with random weights from seed 0: 8 requests served
   twice (cold, then warm through the radix prefix cache), then 8 fresh
   prompts of the same lengths arriving one per step — checking that
   every request ends with its 32 tokens, that no logits row is
   non-finite, and that the kernel carried every attention layer of every
   launch;
6. profile — eight batch-8 decode steps under torch.profiler: step wall
   time, device busy time and idle share, the top kernels;
7. the kernels line, the card line, and the result line.

It imports nothing of JAX and nothing of the ``repro`` package.  Without a
card, or outside a checkout that holds ``src/repro_torch``, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:48"
HBM_BYTES_S = 3.35e12                       # H100 SXM, data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PROMPT_LENS = [5, 17, 40, 64, 100, 200, 300, 33]
MAX_TOKENS = 32


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def rel_err(want, got):
    want, got = want.double(), got.double()
    return float((want - got).abs().max() / want.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# Phase 3 inputs: block tables shaped like the engine's.
# ---------------------------------------------------------------------------

def make_case(rng, *, B, L, hd, Hq, kvh, stride, s_max, dtype,
              qrows=1, ctx=None, start=None, holes=True, layers=1):
    """Random q, per-layer K/V arenas (one per grid row), a scrambled table
    covering each slot's context, and query positions.  ``ctx[b]`` is the
    number of positions slot b's table covers; its L query rows sit at
    ``start[b] + arange(L)``."""
    T = s_max // stride
    if ctx is None:
        ctx = rng.integers(L, s_max + 1, size=B)
    if start is None:
        start = [int(rng.integers(0, c - L + 1)) for c in ctx]
    n_blocks = B * T
    ids = rng.permutation(n_blocks).astype(np.int32)
    table = np.full((B, T), -1, np.int32)
    k = 0
    for b in range(B):
        n = -(-int(ctx[b]) // stride)
        table[b, :n] = ids[k:k + n]
        k += n
        if holes and n > 2 and b % 2:
            table[b, int(rng.integers(1, n))] = -1     # a hole mid-table
    n_loc = -(-n_blocks // qrows)
    q_pos = (torch.tensor(start, dtype=torch.int32)[:, None]
             + torch.arange(L, dtype=torch.int32)[None, :])
    q = torch.from_numpy(rng.standard_normal((B, Hq, L, hd), "float32"))
    arenas = [[(torch.from_numpy(rng.standard_normal(
                  (n_loc, stride, kvh, hd), "float32")).to("cuda", dtype),
                torch.from_numpy(rng.standard_normal(
                    (n_loc, stride, kvh, hd), "float32")).to("cuda", dtype))
               for _ in range(qrows)] for _ in range(layers)]
    return dict(q=q.to("cuda", dtype), arenas=arenas,
                table=torch.from_numpy(table).cuda(), q_pos=q_pos.cuda(),
                stride=stride, qrows=qrows)


def run_rows(fn, c, layer=0):
    return [fn(c["q"], kc, vc, c["table"], c["q_pos"], stride=c["stride"],
               row=row, qrows=c["qrows"])
            for row, (kc, vc) in enumerate(c["arenas"][layer])]


def cuda_ms(fn, iters):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(c, dtype_name):
    """Least time for the work these inputs need: every input byte read
    once (q, the K/V pages the tables reference, table, positions), every
    output byte written once, and 4*hd FLOPs per visible (query, key)
    pair, against 3.35 TB/s and the type's peak."""
    q, table, q_pos, stride = c["q"], c["table"], c["q_pos"], c["stride"]
    B, Hq, L, hd = q.shape
    kc = c["arenas"][0][0][0]
    kvh, isz = kc.shape[2], kc.element_size()
    T = table.shape[1]
    labels = (torch.arange(T, device="cuda")[:, None] * stride
              + torch.arange(stride, device="cuda")[None, :])   # (T, stride)
    used = table >= 0                                            # (B, T)
    n_pages = int(used.sum())
    vis = (q_pos[:, :, None, None] >= labels[None, None]) \
        & used[:, None, :, None]                                 # (B,L,T,s)
    n_pairs = int(vis.sum()) * Hq
    bytes_ = (q.numel() * q.element_size()
              + 2 * n_pages * stride * kvh * hd * isz
              + table.numel() * 4 + q_pos.numel() * 4
              + 2 * B * Hq * L * 4 + B * Hq * L * hd * 4)
    flops = 4 * hd * n_pairs
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def library_call(c, layer):
    """One scaled_dot_product_attention call on the already gathered K/V of
    layer ``layer`` (kv heads repeated for GQA beforehand), same mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import gather_pages
    q = c["q"]
    group = q.shape[1] // c["arenas"][0][0][0].shape[2]
    kc, vc = c["arenas"][layer][0]
    kg, vg, kv_pos = gather_pages(kc, vc, c["table"], stride=c["stride"],
                                  row=0, qrows=1)
    k = kg.transpose(1, 2).repeat_interleave(group, dim=1).contiguous()
    v = vg.transpose(1, 2).repeat_interleave(group, dim=1).contiguous()
    mask = (c["q_pos"][:, :, None] >= kv_pos[:, None, :])[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build():
    from repro_torch.kernels.paged_attention import kernel
    t0 = time.perf_counter()
    kernel.build()
    info = kernel.build_info
    ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         built=info["built"], library=info["path"], ptxas=ptxas)


def phase_kernel_vs_plain():
    from repro_torch.kernels.paged_attention import (merge_rows,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    rng = np.random.default_rng(0)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
    worst = {}
    cases = [dict(B=B, L=L, hd=64, Hq=14, kvh=2, stride=16, s_max=512,
                  dtype=dt) for B in (1, 8) for L in (1, 16, 64, 256)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [dict(B=3, L=L, hd=8, Hq=8, kvh=2, stride=4, s_max=64, dtype=dt,
                   qrows=2) for L in (1, 8)
              for dt in (torch.bfloat16, torch.float32)]
    for spec in cases:
        c = make_case(rng, **spec)
        want = merge_rows(run_rows(paged_attention_ref, c))
        got = merge_rows(run_rows(paged_attention_cuda, c))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"non-finite output {spec}")
        err = rel_err(want, got)
        abs_err = float((want - got).abs().max())
        name = str(spec["dtype"]).split(".")[-1]
        emit("kernel_vs_plain", B=spec["B"], L=spec["L"], hd=spec["hd"],
             qrows=spec.get("qrows", 1), dtype=name, max_rel_err=err,
             max_abs_err=abs_err, tol=tol[spec["dtype"]])
        check(err <= tol[spec["dtype"]], f"kernel disagrees: {spec} rel {err}")
        w = worst.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], abs_err)
    return worst


def phase_timing(n_layers):
    """Kernel, plain and library times at the main path's shapes: batch 8
    of the smoke workload, bf16, cycling over ``n_layers`` arenas as the
    engine's layers do.  Decode rows sit 16 tokens into generation; chunk
    rows are each prompt's first chunk."""
    from repro_torch.kernels.paged_attention import (merge_rows,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    rng = np.random.default_rng(1)
    rows = []
    for L in (1, 16, 64, 256):
        if L == 1:
            ctx = [p + 16 + 1 for p in PROMPT_LENS]
            start = [p + 16 for p in PROMPT_LENS]
        else:
            ctx = [p + 1 for p in PROMPT_LENS]
            start = [0] * len(PROMPT_LENS)
        c = make_case(rng, B=8, L=L, hd=64, Hq=14, kvh=2, stride=16,
                      s_max=512, dtype=torch.bfloat16, ctx=ctx, start=start,
                      holes=False, layers=n_layers)

        def kern(i, c=c):
            run_rows(paged_attention_cuda, c, i % n_layers)

        def plain(i, c=c):
            run_rows(paged_attention_ref, c, i % n_layers)

        libs = [library_call(c, li) for li in range(n_layers)]
        want = merge_rows(run_rows(paged_attention_ref, c))
        got = merge_rows(run_rows(paged_attention_cuda, c))
        t = dict(L=L, B=8, ms=cuda_ms(kern, 4 * n_layers),
                 plain_ms=cuda_ms(plain, n_layers),
                 library_ms=cuda_ms(lambda i: libs[i % n_layers](),
                                    n_layers))
        t["bound_ms"], t["bound_by"] = bound(c, "bfloat16")
        t["max_rel_err"] = rel_err(want, got)
        t["max_abs_err"] = float((want - got).abs().max())
        emit("kernel_timing", **t)
        rows.append(t)
    return rows


def checking_engine():
    """ServingEngine that refuses any non-finite logits row it samples."""
    from repro_torch.serve.engine import ServingEngine

    class Checked(ServingEngine):
        def _commit(self, sd, rows, fed):
            live = [s for s, r in enumerate(sd.slots) if r is not None]
            check(bool(np.isfinite(rows[live]).all()),
                  "non-finite logits row")
            super()._commit(sd, rows, fed)
    return Checked


def phase_reference():
    """The reduced qwen2 config (fp32, hd 8) served on the card through the
    kernel and on the CPU through the plain version, same weights: the
    greedy tokens must agree, and the first chunk's logits to rel 1e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.params import init_params
    from repro_torch.serve.decode import prefill_chunk_step
    from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                          generate)
    from repro_torch.serve.engine.state_store import StateStore
    from repro_torch.serve.state import layer_state_specs
    cfg = reduced(get_config("qwen2-0.5b"))
    gen = torch.Generator("cpu").manual_seed(0)
    cpu_params = init_params(cfg, generator=gen, device="cpu")
    # nonzero biases so the bias path is exercised
    for lp in cpu_params["layers"]:
        for name in ("bq", "bk", "bv"):
            lp["mixer"][name].normal_(0.0, 0.5, generator=gen)
    def to_cuda(t):
        if isinstance(t, dict):
            return {k: to_cuda(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cuda(v) for v in t]
        return t.cuda()
    gpu_params = to_cuda(cpu_params)

    # one chunk step, logits compared directly
    stride, L, B = 4, 16, 4
    specs = layer_state_specs(cfg, stride=stride)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L),
                                         dtype=np.int32))
    pos = torch.tensor([0, 0, 3, 9], dtype=torch.int32)
    n_valid = torch.tensor([16, 9, 4, 1], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(B * 8).astype(np.int32)
                             .reshape(B, 8))
    runs = {"plain": ("cpu", cpu_params), "kernel": ("cuda", gpu_params)}
    outs = []
    for dev, params in runs.values():
        arena = StateStore(specs, n_blocks=B * 8,
                           device=torch.device(dev)).arena
        outs.append(prefill_chunk_step(
            cfg, params, arena, toks.to(dev), pos.to(dev), n_valid.to(dev),
            table.to(dev), stride=stride).cpu())
    step_err = rel_err(outs[0], outs[1])
    check(step_err < 1e-4, f"chunk step logits disagree: rel {step_err}")

    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 3, 30)]
    tokens = {}
    for label, (dev, params) in runs.items():
        ec = EngineConfig(s_max=64, buckets=(1, 2, 4), block_pos_stride=4,
                          prefill_chunks=(4, 16), device=dev)
        eng = checking_engine()(cfg, params=params, engine_cfg=ec)
        outs = generate(eng, prompts, SamplingParams(max_tokens=8))
        tokens[label] = [c.tokens for c in outs]
    check(tokens["plain"] == tokens["kernel"],
          f"greedy tokens differ: cpu {tokens['plain']} "
          f"card {tokens['kernel']}")
    emit("reference", config=cfg.name, step_logits_rel_err=step_err,
         greedy_tokens_match=True, tokens=tokens["kernel"])


def phase_engine():
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.models.params import init_params, param_bytes
    from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                          SamplingParams, completion_of,
                                          generate)
    cfg = get_config("qwen2-0.5b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
           cfg.d_ff, cfg.vocab_size) == (24, 896, 14, 2, 64, 4864, 151936),
          "qwen2-0.5b is not at its published width")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    ec = EngineConfig(s_max=512, buckets=(1, 2, 4, 8), block_pos_stride=16,
                      prefill_chunks=(16, 64, 256), device="cuda")
    eng = checking_engine()(cfg, params=params, engine_cfg=ec)
    emit("engine_setup", config=cfg.name, param_bytes=param_bytes(params),
         arena_bytes=eng.store.arena_bytes(), n_kv_blocks=eng.pool.n_blocks)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    # same lengths, fresh tokens: the arrivals pass misses the prefix cache
    arrivals = [rng.integers(0, cfg.vocab_size, n).tolist()
                for n in PROMPT_LENS]
    sampling = SamplingParams(max_tokens=MAX_TOKENS)

    def at_once(batch):
        return generate(eng, batch, sampling)

    def one_per_step(batch):
        """A request arrives before each step while the earlier ones run,
        so a lone 64..255-token backlog takes the len64 step (all at once,
        the 300-token prompt makes every slot's first chunk len256)."""
        reqs = []
        for p in batch:
            reqs.append(eng.submit(p, sampling))
            eng.step()
        eng.drain()
        return [completion_of(r) for r in reqs]

    # every count to 0 just before the main path, read just after
    paged_attention_cuda.launches = 0
    paged_attention_ref.launches = 0
    passes = {}
    total_launches = 0
    for label, serve_fn, batch in (("cold", at_once, prompts),
                                   ("warm", at_once, prompts),
                                   ("arrivals", one_per_step, arrivals)):
        eng.stats = EngineStats()
        for ev in eng.kernel_events().values():
            ev.first_enqueue_t = ev.last_enqueue_t = ev.last_done_t = 0.0
        t0 = time.perf_counter()
        outs = serve_fn(batch)
        wall = time.perf_counter() - t0
        st = eng.stats
        total_launches += st.launches
        for c in outs:
            check(c.finish_reason == "length" and len(c.tokens) == MAX_TOKENS,
                  f"{c.request_id}: {c.finish_reason} after "
                  f"{len(c.tokens)} tokens")
        ttft = [c.ttft_s for c in outs]
        passes[label] = dict(
            wall_s=wall, tokens=st.tokens_generated,
            tokens_per_s=eng.throughput_tok_s(),
            mean_ttft_ms=1e3 * float(np.mean(ttft)),
            launches=st.launches, decode_launches=st.decode_launches,
            prefill_launches=st.prefill_launches,
            prefill_chunk_launches=st.prefill_chunk_launches,
            prefix_hits=st.prefix_hits, prefix_hit_rate=st.prefix_hit_rate,
            peak_kv_bytes=eng.peak_kv_bytes())
        emit("engine_pass", config=cfg.name, run=label, **passes[label])
    kernel_launches = paged_attention_cuda.launches
    plain_launches = paged_attention_ref.launches
    names = sorted(eng.kernel_events())
    for L in (16, 64, 256):
        check(any(n.endswith(f"_len{L}") for n in names),
              f"no prefill_bs*_len{L} step ran: {names}")
    check(any(n.startswith("serve_step_bs") for n in names),
          f"no serve_step_bs* step ran: {names}")
    check(kernel_launches == cfg.n_layers * total_launches,
          f"kernel launches {kernel_launches} != {cfg.n_layers} x "
          f"{total_launches} engine launches")
    check(plain_launches == 0,
          f"the plain version ran {plain_launches} times on the main path")
    emit("engine", steps=names, kernel_launches=kernel_launches,
         plain_launches=plain_launches, engine_launches=total_launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         warm=passes["warm"])
    return kernel_launches, eng, arrivals, sampling


def phase_profile(eng, prompts, sampling, n_steps=8):
    """Where a batch-8 decode step's time goes: ``n_steps`` steps under
    torch.profiler after the prompts are in.  Device busy time is the sum
    of the kernels' own times; the rest of the host wall is device idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(p, sampling) for p in prompts]
    while not all(r.output_tokens for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    eng.drain()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n_steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit("profile", steps=n_steps, batch=len(prompts),
         step_wall_ms=wall_ms,
         device_busy_ms=busy_ms if kern else "not measured",
         device_idle_share=1 - busy_ms / wall_ms if kern else "not measured",
         kernels_per_step=sum(e.count for e in kern) / n_steps,
         top=[{"name": e.key[:80], "ms_per_step":
               e.self_device_time_total / 1e3 / n_steps,
               "calls_per_step": e.count / n_steps} for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = phase_env()
    phase_build()
    worst = phase_kernel_vs_plain()
    timing = phase_timing(n_layers=24)
    phase_reference()
    launches, eng, prompts, sampling = phase_engine()
    phase_profile(eng, prompts, sampling)

    decode = timing[0]
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": decode["max_abs_err"],
        "max_rel_err": max(w[0] for w in worst.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": "decode: B=8, L=1, Hq=14, kvh=2, hd=64, stride=16, bf16",
        "per_L_ms": {str(t["L"]): t["ms"] for t in timing},
    }]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
