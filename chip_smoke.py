#!/usr/bin/env python3
"""Chip smoke test: repro_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — compile the four CUDA libraries (paged attention; the two
   SSD-scan kernels; the cannon_mm matmul; flash attention) from the
   checkout's sources with nvcc for sm_90a, one nvcc each, started
   together;
3. paged-attention kernel against its plain version on the card — random scrambled block
   tables with holes, qwen2-0.5b head geometry (14 q heads over 2 kv heads,
   hd 64, stride 16), B in {1, 8}, L in {1, 16, 64, 256}, bf16 and fp32
   arenas, contexts up to 512, plus hd 8 with two grid rows sharing the
   pages; then timings at the main path's shapes against the plain
   version, one scaled_dot_product_attention call on the gathered K/V, and
   the least time the card could take;
4. SSD-scan kernels against their plain versions on the card — random
   inputs at the mamba2-780m geometry (48 heads x 64, state 128, 1 group)
   and the reduced one (8 x 16, state 16, 1 or 4 groups), B in {1, 8},
   L in {1, 16, 64, 256}, one or two chunks, zero and non-zero initial
   state, padding columns with dt = 0, bf16 and fp32 x; then timings of
   both kernels at batch 8, L in {16, 64, 256}, bf16, against the plain
   versions and the least time the card could take;
5. end-to-end reference checks — the reduced qwen2, the reduced mamba2 and
   a small hybrid (attention + mamba) config in fp32, served on the card
   and on the CPU (plain versions) from the same weights;
6. the engine at full width — qwen2-0.5b (24 layers, d_model 896, vocab
   151936, bf16), then mamba2-780m (48 layers, d_model 1536, 48 SSD heads,
   vocab 50280, bf16), each with random weights from seed 0: 8 requests
   served twice (cold, then warm through the prefix caches), then 8 fresh
   prompts of the same lengths arriving one per step — checking that
   every request ends with its 32 tokens, that no logits row is
   non-finite, and that the kernels carried every attention (qwen2) or
   mamba (mamba2) layer of every launch that runs them;
7. profile — eight batch-8 decode steps of each model under
   torch.profiler: step wall time, device busy time and idle share, the
   top kernels;
8. the kernels line, the card line, and the result line.

Between 4 and 5 run the phases of the paper core and the last two
kernels:

* mm_vs_plain — the cannon_mm matmul kernel against its plain version
  (tests/test_kernels.py shapes, ragged shapes, a 16-PE stack, transposed
  strides; fp32 and bf16; out_dtype fp32 and default) and its backward
  against autograd through the plain version;
* cannon — every strategy (Cannon natural and pre-skewed, C-rotating,
  allgather, SUMMA, gemv2d) on the emulated 4x4 grid at the Table 1 sizes
  (n = 128, 512, 4096, 8192 fp32; qwen2-0.5b's 4096 x 896 x 4864 MLP
  up-projection in bf16) against a host fp64 product, with the matmul
  kernel counted (q launches per Cannon and SUMMA call, 1 per allgather
  and gemv2d call, the plain version never); then the Table 1 rows
  (launch/table1.py: hybrid against allgather through the CommandQueue);
* mm_timing — the matmul at 4096^3 bf16 and fp32 and at the n = 8192
  Cannon round (16 x 2048^3 fp32) against its plain version, one
  torch.matmul and its bound;
* flash_vs_plain and flash_timing — the flash-attention kernel against
  its plain version (tests/test_kernels.py shapes, ragged tails, an
  offset block), then the op at qwen2-0.5b's and qwen3-0.6b's prefill
  geometries (S 4096, B 1 and 4, causal, bf16), counted, and timed
  against the plain version, scaled_dot_product_attention and the bound.

It imports nothing of JAX and nothing of the ``repro`` package.  Without a
card, or outside a checkout that holds ``src/repro_torch``, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention/kernel.py:48"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = {"ssd_chunk": "src/repro/kernels/ssd_scan/kernel.py:74",
                "ssd_apply": "src/repro/kernels/ssd_scan/kernel.py:117"}
MM_SOURCE = "src/repro_torch/kernels/cannon_mm/csrc/cannon_mm.cu"
MM_REPLACES = "src/repro/kernels/cannon_mm/kernel.py:51"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:75"
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
    """One nvcc per source, all started together."""
    from repro_torch.kernels.cannon_mm import kernel as mm
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    mods = {"paged_attention": paged, "ssd_scan": ssd, "cannon_mm": mm,
            "flash_attention": flash}
    with ThreadPoolExecutor(len(mods)) as pool:
        for fut in [pool.submit(m.build) for m in mods.values()]:
            fut.result()
    for name, m in mods.items():
        info = m.build_info
        ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        emit("build", library=name, seconds=round(info["seconds"], 3),
             built=info["built"], path=info["path"], ptxas=ptxas)
    emit("build_total", seconds=round(time.perf_counter() - t0, 3))


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


# ---------------------------------------------------------------------------
# Phase 4: the SSD-scan kernels.
# ---------------------------------------------------------------------------

MAMBA2_GEOM = dict(H=48, P=64, G=1, N=128)          # mamba2-780m
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def ssd_inputs(rng, *, B, S, H, P, G, N, dtype, pad=0, init=True,
               packed=True):
    """Random SSD operands on the card: x, dt = softplus(normal) with the
    last ``pad`` positions zeroed (padding columns), A = -exp(U(log .5,
    log 8)), B/C, and an initial state (zeros unless ``init``).  With
    ``packed`` x, B and C are column slices of one (B, S, H*P + 2*G*N)
    tensor, as the mamba layer hands them to the scan; else each is
    contiguous."""
    x = rng.standard_normal((B, S, H, P), "float32") * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), "float32")))
    if pad:
        dt[:, S - pad:] = 0.0
    A = -np.exp(rng.uniform(np.log(0.5), np.log(8.0), H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), "float32") * 0.3
    Cm = rng.standard_normal((B, S, G, N), "float32") * 0.3
    s0 = rng.standard_normal((B, H, N, P), "float32") if init \
        else np.zeros((B, H, N, P), np.float32)
    cuda = lambda a, d=torch.float32: torch.from_numpy(a).to("cuda", d)
    if packed:
        di, gn = H * P, G * N
        xbc = cuda(np.concatenate([a.reshape(B, S, -1) for a in (x, Bm, Cm)],
                                  axis=-1), dtype)
        return (xbc[..., :di].reshape(B, S, H, P), cuda(dt), cuda(A),
                xbc[..., di:di + gn].reshape(B, S, G, N),
                xbc[..., di + gn:].reshape(B, S, G, N), cuda(s0))
    return (cuda(x, dtype), cuda(dt), cuda(A), cuda(Bm, dtype),
            cuda(Cm, dtype), cuda(s0))


def ssd_case_errors(ops, chunk):
    """Kernel against plain version on one input set: pass 1's three
    outputs, then pass 2 on the plain pass 1's outputs and the state that
    enters each chunk.  Returns {output: (max rel err, max abs err)}."""
    from repro_torch.kernels.ssd_scan import _state_passing
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_apply_ref, ssd_chunk_ref
    x, dt, A, Bm, Cm, s0 = ops
    B, S = x.shape[:2]
    G, N = Bm.shape[2:]
    want = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=chunk)
    got = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    states_in, _ = _state_passing(want[1], want[2][:, :, -1, :], s0)
    cr = Cm.reshape(B, S // chunk, chunk, G, N)
    want_y = ssd_apply_ref(want[0], cr, want[2], states_in)
    got_y = ssd_apply_cuda(want[0], cr, want[2], states_in)
    torch.cuda.synchronize()
    out = {}
    for name, w, g in zip(("y_intra", "states", "cumexp", "y"),
                          (*want, want_y), (*got, got_y)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
              f"{w.dtype}")
        check(bool(torch.isfinite(g).all()), f"non-finite {name}")
        out[name] = (rel_err(w, g), float((w.double() - g.double())
                                          .abs().max()))
    return out


def phase_ssd_vs_plain():
    """Both SSD kernels against their plain versions over the cases of the
    main path and the reduced geometry.  Tolerances (max abs difference
    over max abs value): y_intra and y 1e-4 with fp32 x, 1e-2 with bf16 x
    (each rounded to bf16: a last-bit flip is 2^-8 of an element); states
    and cumexp, fp32 in both, 1e-4 (the cumsum of dt * A and the sums over
    s and n run in another order than torch).  Half the cases hand x, B and
    C over as slices of one packed tensor, the rest contiguous."""
    rng = np.random.default_rng(3)
    cases = []
    for B in (1, 8):
        for L in (1, 16, 64, 256):
            for dt in (torch.bfloat16, torch.float32):
                cases.append(dict(B=B, L=L, nc=2 if B == 1 else 1, dtype=dt,
                                  pad=L // 4, init=(L // 16) % 2 == 0,
                                  **MAMBA2_GEOM))
    for G in (1, 4):
        for L in (16, 64):
            for nc in (1, 2):
                for dt in (torch.bfloat16, torch.float32):
                    cases.append(dict(B=8 if nc == 1 else 1, L=L, nc=nc,
                                      dtype=dt, pad=3 * (nc == 1),
                                      init=nc == 2, H=8, P=16, G=G, N=16))
    worst = {}
    for i, c in enumerate(cases):
        # each bf16/fp32 pair of cases runs one packed, the other
        # contiguous, alternating which from pair to pair
        c["packed"] = (i + i // 2) % 2 == 0
        ops = ssd_inputs(rng, B=c["B"], S=c["L"] * c["nc"], H=c["H"],
                         P=c["P"], G=c["G"], N=c["N"], dtype=c["dtype"],
                         pad=c["pad"], init=c["init"], packed=c["packed"])
        errs = ssd_case_errors(ops, c["L"])
        name = str(c["dtype"]).split(".")[-1]
        tol = {"y_intra": SSD_TOL[c["dtype"]], "y": SSD_TOL[c["dtype"]],
               "states": 1e-4, "cumexp": 1e-4}
        emit("ssd_vs_plain", **{k: v for k, v in c.items() if k != "dtype"},
             dtype=name, max_rel_err={k: e[0] for k, e in errs.items()},
             max_abs_err={k: e[1] for k, e in errs.items()}, tol=tol)
        for k, (rel, abs_) in errs.items():
            check(rel <= tol[k], f"ssd kernels disagree on {k}: {c} "
                  f"rel {rel}")
            kern = "ssd_apply" if k == "y" else "ssd_chunk"
            w = worst.setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], rel), max(w[1], abs_)
    return worst


def ssd_bound(B, nc, L, H, P, G, N, esz):
    """Least time of each pass on these inputs, against 3.35 TB/s and the
    fp32 peak (the kernels compute in fp32 on the CUDA cores).  Bytes: every
    input read once, every output written once.  Operations: the causal
    half of the work the data needs — pass 1 the scores C.B (s <= t), the
    decayed weights, y_intra and the chunk states; pass 2 C.state_in, the
    cumexp scale and the add."""
    S, tri = nc * L, L * (L + 1) // 2
    chunk_bytes = (B * S * H * P * esz * 2 + B * S * H * 4 * 2 + H * 4
                   + 2 * B * S * G * N * esz + B * nc * H * N * P * 4)
    chunk_ops = B * nc * (2 * G * N * tri + 3 * H * tri + 2 * H * P * tri
                          + 2 * H * N * P * L + H * N * L)
    apply_bytes = (B * S * H * P * esz * 2 + B * S * G * N * esz
                   + B * S * H * 4 + B * nc * H * N * P * 4)
    apply_ops = B * S * H * P * (2 * N + 2)
    out = {}
    for name, by, ops in (("ssd_chunk", chunk_bytes, chunk_ops),
                          ("ssd_apply", apply_bytes, apply_ops)):
        tb = by / HBM_BYTES_S * 1e3
        to = ops / PEAK_FLOPS["float32"] * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def device_ms(fn, iters, names):
    """Device time per call of the CUDA kernels whose names contain one of
    ``names``, from torch.profiler: the card's own time, without the host
    time of the wrapper that launches them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / iters if us else "not measured"


def phase_ssd_timing(n_sets=4):
    """Kernel and plain times of both passes at the main path's shapes:
    batch 8, one chunk of L in {16, 64, 256}, mamba2-780m geometry, bf16,
    x, B and C packed as the mamba layer gives them, cycling over
    ``n_sets`` input sets.  ``ms`` is CUDA events around back-to-back
    wrapper calls (it includes the wrapper's host time when that is the
    longer); ``device_ms`` is the kernels' own device time; the chunk
    pass's ``copy_ms`` is what making x, B and C contiguous would add to
    it (the kernels read them in place)."""
    from repro_torch.kernels.ssd_scan import _state_passing
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_apply_ref, ssd_chunk_ref
    rng = np.random.default_rng(4)
    g = MAMBA2_GEOM
    rows = []
    for L in (16, 64, 256):
        sets = []
        for _ in range(n_sets):
            ops = ssd_inputs(rng, B=8, S=L, dtype=torch.bfloat16, **g)
            x, dt, A, Bm, Cm, s0 = ops
            p1 = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=L)
            s_in, _ = _state_passing(p1[1], p1[2][:, :, -1, :], s0)
            sets.append((ops, p1, Cm.reshape(8, 1, L, g["G"], g["N"]), s_in))

        def chunk(fn, i):
            x, dt, A, Bm, Cm, _ = sets[i % n_sets][0]
            fn(x, dt, A, Bm, Cm, chunk=L)

        def apply(fn, i):
            _, p1, cr, s_in = sets[i % n_sets]
            fn(p1[0], cr, p1[2], s_in)

        def copies(i):
            x, _, _, Bm, Cm, _ = sets[i % n_sets][0]
            for t in (x, Bm, Cm):
                t.contiguous()

        bounds = ssd_bound(8, 1, L, g["H"], g["P"], g["G"], g["N"], 2)
        errs = ssd_case_errors(sets[0][0], L)
        for name, run, kern, plain, dev_names in (
                ("ssd_chunk", chunk, ssd_chunk_cuda, ssd_chunk_ref,
                 ("scores_kernel", "intra_kernel", "state_kernel")),
                ("ssd_apply", apply, ssd_apply_cuda, ssd_apply_ref,
                 ("apply_kernel",))):
            t = dict(kernel=name, L=L, B=8, dtype="bfloat16",
                     ms=cuda_ms(lambda i: run(kern, i), 20),
                     device_ms=device_ms(lambda i: run(kern, i), 20,
                                         dev_names),
                     plain_ms=cuda_ms(lambda i: run(plain, i), 5),
                     bound_ms=bounds[name][0], bound_by=bounds[name][1],
                     library_ms=None)
            if name == "ssd_chunk":
                t["copy_ms"] = cuda_ms(copies, 20)
            keys = ("y",) if name == "ssd_apply" else \
                ("y_intra", "states", "cumexp")
            t["max_rel_err"] = max(errs[k][0] for k in keys)
            t["max_abs_err"] = max(errs[k][1] for k in keys)
            emit("ssd_timing", **t)
            rows.append(t)
    return rows


# ---------------------------------------------------------------------------
# The paper core: the cannon_mm kernel, the emulated 4x4 grid, Table 1.
# ---------------------------------------------------------------------------

MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
STRATEGY_LAUNCHES = {"cannon": 4, "cannon_preskewed": 4, "crot": 4,
                     "allgather": 1, "summa": 4, "gemv2d": 1}


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .to("cuda", dtype)


def dname(dtype):
    return str(dtype).split(".")[-1]


def phase_mm_vs_plain():
    """The matmul kernel against its plain version on the card: the
    tests/test_kernels.py shapes, two ragged shapes, a P = 16 stack and a
    transposed-stride case, fp32 and bf16 operands, ``out_dtype`` fp32 and
    the default; then the backward of the op against autograd through the
    plain version (P = 16).  Tolerance: max abs difference over max abs
    value 2e-4 with fp32 operands (fp32 FMAs, never TF32, another summation
    order), 3e-2 with bf16 (one rounding of the output to bf16)."""
    from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    rng = np.random.default_rng(5)
    cases = [((m, k), (k, n), False) for m, k, n in (
        (256, 256, 256), (512, 256, 384), (128, 512, 128), (128, 128, 128),
        (100, 37, 130), (257, 129, 65))]
    cases += [((16, 64, 48), (16, 48, 80), False),
              ((96, 200), (72, 96), True)]          # a.T @ b.T, as strides
    worst = [0.0, 0.0]
    for sa, sb, transposed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = randn(rng, sa, dtype), randn(rng, sb, dtype)
            if transposed:
                a, b = a.t(), b.t()
            for out_dtype in (None, torch.float32):
                want = matmul_ref(a, b, out_dtype)
                got = matmul_cuda(a, b, out_dtype=out_dtype)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"matmul {sa} {sb}: {tuple(got.shape)} {got.dtype}")
                err, abs_err = rel_err(want, got), float(
                    (want.double() - got.double()).abs().max())
                emit("mm_vs_plain", a=list(a.shape), b=list(b.shape),
                     a_strides=list(a.stride()), dtype=dname(dtype),
                     out_dtype=dname(got.dtype), max_rel_err=err,
                     max_abs_err=abs_err, tol=MM_TOL[dtype])
                check(err <= MM_TOL[dtype],
                      f"matmul kernel disagrees: {sa} {sb} {dtype} rel {err}")
                worst = [max(worst[0], err), max(worst[1], abs_err)]
    for dtype in (torch.float32, torch.bfloat16):
        a, b = randn(rng, (16, 48, 64), dtype), randn(rng, (16, 64, 40), dtype)
        g = randn(rng, (16, 48, 40), torch.float32)
        grads = []
        for fn in (lambda x, y: matmul_ref(x, y, torch.float32),
                   lambda x, y: blocked_matmul(x, y, out_dtype=torch.float32)):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            fn(x, y).backward(g)
            grads.append((x.grad, y.grad))
        torch.cuda.synchronize()
        errs = [rel_err(w, o) for w, o in zip(*grads)]
        emit("mm_backward_vs_autograd", dtype=dname(dtype), dA_rel_err=errs[0],
             dB_rel_err=errs[1], tol=MM_TOL[dtype])
        check(max(errs) <= MM_TOL[dtype], f"matmul backward disagrees: {errs}")
    return worst


def strategy_errors(A, B, C, scale, n_rows=8):
    """Every strategy of repro_torch.core.cannon on the emulated 4x4 grid,
    A @ B against the fp64 product C (max abs difference over max |C|);
    gemv2d multiplies A's first ``n_rows`` rows.  Checks the matmul kernel
    ran as many times as each strategy has rounds, and never its plain
    version."""
    from repro_torch.core import ShmemGrid, cannon
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    q = 4
    a = cannon.block_2d(A, q, q)
    nat, pre = cannon.block_2d(B, q, q), cannon.block_2d(B, q, q, True)
    crot_b = cannon.block_2d(B, q, q, "crot")

    def crot(g, a_, _):
        out = cannon.cannon_matmul_crot(g, a_, crot_b)  # at (i, j): N_(i+j)%q
        order = [i * q + (j - i) % q for i in range(q) for j in range(q)]
        return out[order]

    def gemv(g, a_, b_):
        x = A[:n_rows]
        kb = x.shape[1] // q
        xs = torch.stack([x[:, (p % q) * kb:(p % q + 1) * kb]
                          for p in range(q * q)])
        out = cannon.gemv2d(g, xs, b_)               # (P, n_rows, N/q)
        check(bool((out == out[:q].repeat(q, 1, 1)).all()),
              "gemv2d output is not replicated over grid rows")
        return torch.cat(list(out[:q]), dim=1)

    runs = {"cannon": (cannon.cannon_matmul, nat, {}),
            "cannon_preskewed": (cannon.cannon_matmul, pre,
                                 dict(preskewed_b=True)),
            "crot": (crot, None, {}),
            "allgather": (cannon.allgather_matmul, nat, {}),
            "summa": (cannon.summa_matmul, nat, {}),
            "gemv2d": (gemv, nat, {})}
    errs = {}
    for name, (fn, b, kw) in runs.items():
        n_ker, n_ref = matmul_cuda.launches, matmul_ref.launches
        out = fn(ShmemGrid(q, q), a, b, **kw)
        torch.cuda.synchronize()
        ran = (matmul_cuda.launches - n_ker, matmul_ref.launches - n_ref)
        check(ran == (STRATEGY_LAUNCHES[name], 0),
              f"{name}: kernel and plain launches {ran}, expected "
              f"({STRATEGY_LAUNCHES[name]}, 0)")
        got = out if name == "gemv2d" else cannon.unblock_2d(out, q, q)
        want = C[:n_rows] if name == "gemv2d" else C
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        errs[name] = float((got.double() - want).abs().max()) / scale
        del out, got
    return errs


def phase_cannon():
    """The slice's main path: every strategy on the emulated 4x4 grid on the
    card at the Table 1 sizes (fp32 n = 128, 512, 4096, 8192; qwen2-0.5b's
    MLP up-projection in bf16), against a host fp64 product of the same
    operands.  The kernel counts are set to 0 just before and read just
    after.  Then the Table 1 measurement (launch/table1.py) on the same
    operands: hybrid Cannon against the allgather baseline through the
    CommandQueue."""
    from repro_torch.core import CommandQueue
    from repro_torch.core.epiphany_model import table1_report
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    from repro_torch.launch import table1
    rows, meta = table1_report()
    for r in rows:
        emit("table1_model", **r)
    emit("table1_fit", **meta)
    queue = CommandQueue("cuda")
    worst, live = {}, []
    counts = {"launches": 0, "plain": 0}
    for spec in table1.DEFAULT_SIZES:
        M, K, N, dtype = table1.parse_size(spec)
        t0 = time.perf_counter()
        A, B, C = table1.operands(M, K, N, dtype, 0, torch.device("cuda"))
        setup_s = time.perf_counter() - t0
        scale = float(C.abs().max())
        matmul_cuda.launches = matmul_ref.launches = 0     # counts to 0 ...
        errs = strategy_errors(A, B, C, scale)
        counts["launches"] += matmul_cuda.launches          # ... read
        counts["plain"] += matmul_ref.launches
        tol = MM_TOL[dtype]
        emit("cannon", size=spec, dtype=dname(dtype), operands_s=setup_s,
             max_rel_err=errs, tol=tol)
        for name, e in errs.items():
            check(e <= tol, f"cannon {name} at {spec}: rel {e} > {tol}")
            worst[name] = max(worst.get(name, 0.0), e)
        row = table1.measure(queue, spec, A, B, C)
        for name in ("hybrid", "opencl"):
            check(row[f"{name}_max_rel_err"] <= tol,
                  f"table1 {name} at {spec}: {row}")
        emit("table1_live", **row)
        live.append(row)
        del A, B, C
        torch.cuda.empty_cache()
    expect = len(table1.DEFAULT_SIZES) * sum(STRATEGY_LAUNCHES.values())
    check(counts == {"launches": expect, "plain": 0},
          f"cannon main path: matmul launches {counts}, expected {expect} "
          f"and 0 plain")
    return counts["launches"], worst, live


def mm_bound(P, M, K, N, dtype, out_dtype):
    """Least time of one call: each input element read once and each output
    element written once at 3.35 TB/s, against 2*P*M*N*K operations at the
    input type's peak (fp32 FMAs: 67 TFLOP/s; bf16 tensor cores: 989)."""
    esz = torch.tensor([], dtype=dtype).element_size()
    osz = torch.tensor([], dtype=out_dtype).element_size()
    tb = (P * (M * K + K * N) * esz + P * M * N * osz) / HBM_BYTES_S * 1e3
    to = 2 * P * M * N * K / PEAK_FLOPS[dname(dtype)] * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def phase_mm_timing():
    """Kernel, plain and library times of the matmul at 4096^3 in bf16 and
    fp32, and at the n = 8192 Cannon round (16 PEs x 2048^3, fp32), the
    main path's largest.  ``ms`` is CUDA events around back-to-back wrapper
    calls, ``device_ms`` the kernel's own time from torch.profiler;
    ``library_ms`` is one torch.matmul (TF32 off), timed and never used."""
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    rng = np.random.default_rng(6)
    rows = []
    for label, P, M, K, N, dtype in (
            ("4096^3 bf16", 1, 4096, 4096, 4096, torch.bfloat16),
            ("4096^3 fp32", 1, 4096, 4096, 4096, torch.float32),
            ("cannon round n=8192: 16 x 2048^3 fp32", 16, 2048, 2048, 2048,
             torch.float32)):
        a, b = randn(rng, (P, M, K), dtype), randn(rng, (P, K, N), dtype)
        if P == 1:
            a, b = a[0], b[0]
        want, got = matmul_ref(a, b), matmul_cuda(a, b)
        torch.cuda.synchronize()
        t = dict(shape=label, P=P, M=M, K=K, N=N, dtype=dname(dtype),
                 ms=cuda_ms(lambda i: matmul_cuda(a, b), 10),
                 device_ms=device_ms(lambda i: matmul_cuda(a, b), 5,
                                     ("mm_f32_kernel", "mm_bf16_kernel")),
                 plain_ms=cuda_ms(lambda i: matmul_ref(a, b), 5),
                 library_ms=cuda_ms(lambda i: torch.matmul(a, b), 10),
                 max_rel_err=rel_err(want, got),
                 max_abs_err=float((want.double() - got.double())
                                   .abs().max()))
        t["bound_ms"], t["bound_by"] = mm_bound(P, M, K, N, dtype, dtype)
        emit("mm_timing", **t)
        check(t["max_rel_err"] <= MM_TOL[dtype], f"matmul timing case {t}")
        rows.append(t)
        del a, b, want, got
    return rows


# ---------------------------------------------------------------------------
# Flash attention.
# ---------------------------------------------------------------------------

def flash_inputs(rng, B, Hq, Hkv, Sq, Skv, D, dtype):
    return (randn(rng, (B, Hq, Sq, D), dtype),
            randn(rng, (B, Hkv, Skv, D), dtype),
            randn(rng, (B, Hkv, Skv, D), dtype))


FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-5}


def flash_elem_err(want, got):
    """Largest elementwise |got - want| over its limit (a pass is <= 1):
    fp32 2e-5 absolute; bf16 one bf16 ulp of |want| plus 1e-5.  Both
    sides compute in fp32 and round once to the output type, so a
    bf16 element is off by at most one ulp; the 1e-5 covers outputs near
    zero, sums that cancel, where fp32's own rounding (about 1e-6 over a
    few thousand keys) is several bf16 ulps.  Unlike the max over the
    output's max, this holds every row to its own magnitude: a row that
    averages thousands of values (std about 0.03) fails if one of its key
    tiles is wrong."""
    d = (want.double() - got.double()).abs()
    lim = torch.full_like(d, FLASH_ATOL[got.dtype])
    if got.dtype == torch.bfloat16:
        w = want.double().abs().clamp_min(2.0 ** -126)
        lim += torch.exp2(torch.floor(torch.log2(w)) - 7)
    return float((d / lim).max())


def phase_flash_vs_plain():
    """The flash kernel against its plain version on the card: the
    tests/test_kernels.py shapes, a ragged shape and a q_offset > 0 case
    with ragged tails, fp32 and bf16, causal and not (offset 0).
    Tolerance: max abs difference over max abs value 2e-4 (fp32) and 3e-2
    (bf16: the output is rounded to bf16), and every element within
    ``flash_elem_err``'s limit."""
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    rng = np.random.default_rng(7)
    worst = [0.0, 0.0, 0.0]
    for shape in ((2, 4, 2, 256, 256, 64, 0), (1, 8, 8, 128, 512, 32, 384),
                  (2, 4, 1, 128, 128, 128, 0), (1, 2, 2, 384, 384, 64, 0),
                  (2, 14, 2, 100, 100, 64, 0), (1, 16, 8, 77, 301, 128, 224)):
        B, Hq, Hkv, Sq, Skv, D, off = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(rng, B, Hq, Hkv, Sq, Skv, D, dtype)
            for causal in (True, False):
                o = off if causal else 0
                want = attention_ref(q, k, v, causal=causal, q_offset=o)
                got = flash_attention_cuda(q, k, v, causal=causal, q_offset=o)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == q.shape,
                      f"flash {shape}: {got.dtype} {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()),
                      f"flash {shape}: non-finite output")
                err = rel_err(want, got)
                abs_err = float((want.double() - got.double()).abs().max())
                elem = flash_elem_err(want, got)
                emit("flash_vs_plain", shape=list(shape), q_offset=o,
                     causal=causal, dtype=dname(dtype), max_rel_err=err,
                     max_abs_err=abs_err, tol=MM_TOL[dtype],
                     elem_err=elem)
                check(err <= MM_TOL[dtype] and elem <= 1.0,
                      f"flash kernel disagrees: {shape} {dtype} {causal} "
                      f"rel {err} elementwise {elem}")
                worst = [max(worst[0], err), max(worst[1], abs_err),
                         max(worst[2], elem)]
    return worst


FLASH_GEOMS = (("qwen2-0.5b B=1", 1, 14, 2, 64), ("qwen2-0.5b B=4", 4, 14, 2, 64),
               ("qwen3-0.6b B=1", 1, 16, 8, 128),
               ("qwen3-0.6b B=4", 4, 16, 8, 128))
FLASH_S = 4096


def flash_bound(B, Hq, Hkv, S, D, esz):
    """Least time of one causal call: q, k, v read once and the output
    written once at 3.35 TB/s, against the causal half of 4*B*Hq*S*S*D
    (the S(S+1)/2 visible pairs) at the bf16 tensor-core peak."""
    tb = (2 * B * Hq * S * D + 2 * B * Hkv * S * D) * esz / HBM_BYTES_S * 1e3
    to = 4 * B * Hq * D * S * (S + 1) / 2 / PEAK_FLOPS["bfloat16"] * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def phase_flash_timing():
    """The flash op's path: one causal bf16 call per prefill geometry
    (qwen2-0.5b: 14 q over 2 kv heads, D 64; qwen3-0.6b: 16 over 8, D 128;
    B 1 and 4; S 4096) through the public op, with the counts set to 0
    just before and read just after; then kernel, plain and library times
    at each.  The library call is scaled_dot_product_attention (is_causal)
    on K/V repeated to Hq beforehand, timed and never used."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    rng = np.random.default_rng(8)
    inputs = [flash_inputs(rng, B, Hq, Hkv, FLASH_S, FLASH_S, D,
                           torch.bfloat16) for _, B, Hq, Hkv, D in FLASH_GEOMS]
    flash_attention_cuda.launches = attention_ref.launches = 0
    outs = [flash_attention(*x) for x in inputs]
    torch.cuda.synchronize()
    launches = flash_attention_cuda.launches
    check((launches, attention_ref.launches) == (len(FLASH_GEOMS), 0),
          f"flash path: kernel {launches}, plain {attention_ref.launches}")
    rows = []
    for (label, B, Hq, Hkv, D), (q, k, v), got in zip(FLASH_GEOMS, inputs,
                                                       outs):
        want = attention_ref(q, k, v)
        kr = k.repeat_interleave(Hq // Hkv, dim=1)
        vr = v.repeat_interleave(Hq // Hkv, dim=1)
        t = dict(geometry=label, B=B, Hq=Hq, Hkv=Hkv, S=FLASH_S, D=D,
                 dtype="bfloat16",
                 ms=cuda_ms(lambda i: flash_attention_cuda(q, k, v), 5),
                 device_ms=device_ms(lambda i: flash_attention_cuda(q, k, v),
                                     3, ("flash_kernel",)),
                 plain_ms=cuda_ms(lambda i: attention_ref(q, k, v), 2),
                 library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
                     q, kr, vr, is_causal=True), 5),
                 max_rel_err=rel_err(want, got),
                 max_abs_err=float((want.double() - got.double())
                                   .abs().max()),
                 elem_err=flash_elem_err(want, got))
        t["bound_ms"], t["bound_by"] = flash_bound(B, Hq, Hkv, FLASH_S, D, 2)
        emit("flash_timing", **t)
        check(t["max_rel_err"] <= MM_TOL[torch.bfloat16]
              and t["elem_err"] <= 1.0, f"flash {t}")
        rows.append(t)
        del want, kr, vr
    del inputs, outs
    torch.cuda.empty_cache()
    return launches, rows


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


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def hybrid_config():
    """A small attention + mamba config (tests/test_engine_state.py's
    HYBRID): the only card run of the hybrid path."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
        n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
        ssm_headdim=16, ssm_state=16, ssm_groups=4,
        layer_pattern=(("attn", "mlp"), ("mamba", "mlp")),
        param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_block_kv=32)


def reference_check(cfg):
    """``cfg`` (fp32) served on the card through the kernels and on the CPU
    through the plain versions, same weights: one chunk step's logits to
    rel 1e-4, then the greedy tokens of an engine run must be equal."""
    from repro_torch.models.params import init_params
    from repro_torch.serve.decode import prefill_chunk_step
    from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                          generate)
    from repro_torch.serve.engine.state_store import StateStore
    from repro_torch.serve.state import layer_state_specs
    gen = torch.Generator("cpu").manual_seed(0)
    cpu_params = init_params(cfg, generator=gen, device="cpu")
    # nonzero biases so the bias paths are exercised
    for lp in cpu_params["layers"]:
        for name in ("bq", "bk", "bv", "conv_b", "dt_bias"):
            if name in lp["mixer"]:
                lp["mixer"][name].normal_(0.0, 0.5, generator=gen)
    gpu_params = to_device(cpu_params, "cuda")

    # one chunk step, logits compared directly
    stride, L, B, n_slots = 4, 16, 4, 5
    specs = layer_state_specs(cfg, stride=stride)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L),
                                         dtype=np.int32))
    pos = torch.tensor([0, 0, 3, 9], dtype=torch.int32)
    n_valid = torch.tensor([16, 9, 4, 1], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(B * 8).astype(np.int32)
                             .reshape(B, 8)) if specs.has_paged else None
    slots = torch.tensor([3, 0, 4, 1], dtype=torch.int32) \
        if specs.has_dense else None
    runs = {"plain": ("cpu", cpu_params), "kernel": ("cuda", gpu_params)}
    outs = []
    for dev, params in runs.values():
        arena = StateStore(specs, n_blocks=B * 8, device=torch.device(dev),
                           n_slots=n_slots, stride=stride).arena
        ops = [None if t is None else t.to(dev) for t in (table, slots)]
        outs.append(prefill_chunk_step(
            cfg, params, arena, toks.to(dev), pos.to(dev), n_valid.to(dev),
            *ops, stride=stride).cpu())
    step_err = rel_err(outs[0], outs[1])
    check(step_err < 1e-4,
          f"{cfg.name}: chunk step logits disagree: rel {step_err}")

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
          f"{cfg.name}: greedy tokens differ: cpu {tokens['plain']} "
          f"card {tokens['kernel']}")
    emit("reference", config=cfg.name, step_logits_rel_err=step_err,
         greedy_tokens_match=True, tokens=tokens["kernel"])


def phase_reference():
    from repro_torch.configs import get_config, reduced
    for cfg in (reduced(get_config("qwen2-0.5b")),
                reduced(get_config("mamba2-780m")), hybrid_config()):
        reference_check(cfg)


def kernel_counters():
    """name -> (the wrapper whose count is the kernel's launches, the plain
    version that must not run on the main path)."""
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_apply_ref, ssd_chunk_ref
    return {"paged_attention": (paged_attention_cuda, paged_attention_ref),
            "ssd_chunk": (ssd_chunk_cuda, ssd_chunk_ref),
            "ssd_apply": (ssd_apply_cuda, ssd_apply_ref)}


def serve_passes(eng, cfg, prompts, arrivals, sampling):
    """Cold, warm and one-per-step arrival passes; returns per-pass stats
    and the engine launches of all three (by kind)."""
    from repro_torch.serve.engine import EngineStats, completion_of, generate

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

    passes = {}
    totals = {"launches": 0, "prefill_chunk_launches": 0}
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
        totals["launches"] += st.launches
        totals["prefill_chunk_launches"] += st.prefill_chunk_launches
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
            prompt_tokens_ingested=st.prompt_tokens_ingested,
            prefix_hits=st.prefix_hits, prefix_hit_rate=st.prefix_hit_rate,
            peak_dense_slots_used=st.peak_dense_slots_used,
            peak_kv_bytes=eng.peak_kv_bytes())
        emit("engine_pass", config=cfg.name, run=label, **passes[label])
    names = sorted(eng.kernel_events())
    for L in (16, 64, 256):
        check(any(n.endswith(f"_len{L}") for n in names),
              f"no prefill_bs*_len{L} step ran: {names}")
    check(any(n.startswith("serve_step_bs") for n in names),
          f"no serve_step_bs* step ran: {names}")
    return passes, totals, names


def phase_engine(arch):
    """The main path of one full-width model: its kernels' counts are set
    to 0 just before the three passes and read just after.  An attention
    layer launches the paged-attention kernel on every engine launch; a
    mamba layer launches both SSD kernels on every chunk launch (decode
    runs the one-token recurrence)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params, param_bytes
    from repro_torch.serve.engine import EngineConfig, SamplingParams
    cfg = get_config(arch)
    widths = {"qwen2-0.5b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.d_ff, cfg.vocab_size), (24, 896, 14, 2, 64, 4864, 151936)),
        "mamba2-780m": (
        (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
         cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups, cfg.conv_kernel,
         cfg.vocab_size), (48, 1536, 3072, 48, 64, 128, 1, 4, 50280))}
    got, want = widths[arch]
    check(got == want, f"{arch} is not at its published width: {got}")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    ec = EngineConfig(s_max=512, buckets=(1, 2, 4, 8), block_pos_stride=16,
                      prefill_chunks=(16, 64, 256), device="cuda")
    eng = checking_engine()(cfg, params=params, engine_cfg=ec)
    emit("engine_setup", config=cfg.name, param_bytes=param_bytes(params),
         arena_bytes=eng.store.arena_bytes(), n_kv_blocks=eng.pool.n_blocks,
         dense_slot_bytes=eng.store.dense_slot_bytes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    # same lengths, fresh tokens: the arrivals pass misses the prefix cache
    arrivals = [rng.integers(0, cfg.vocab_size, n).tolist()
                for n in PROMPT_LENS]
    sampling = SamplingParams(max_tokens=MAX_TOKENS)

    counters = kernel_counters()
    for kern, plain in counters.values():      # every count to 0 ...
        kern.launches = plain.launches = 0
    passes, totals, names = serve_passes(eng, cfg, prompts, arrivals,
                                         sampling)
    launches = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: p.launches for k, (_, p) in counters.items()}  # ... read
    mixers = [m for m, _ in cfg.pattern()]
    per_group = {"paged_attention": mixers.count("attn") * totals["launches"],
                 "ssd_chunk": mixers.count("mamba")
                 * totals["prefill_chunk_launches"],
                 "ssd_apply": mixers.count("mamba")
                 * totals["prefill_chunk_launches"]}
    for k, n in per_group.items():
        expect = cfg.n_groups() * n
        check(launches[k] == expect,
              f"{arch}: {k} launches {launches[k]} != {expect}")
        check(plain[k] == 0,
              f"{arch}: the plain {k} ran {plain[k]} times on the main path")
    if eng.store.has_dense:
        check(passes["warm"]["prompt_tokens_ingested"]
              < passes["cold"]["prompt_tokens_ingested"],
              "the warm pass adopted no dense prefix snapshot")
    emit("engine", config=cfg.name, steps=names, kernel_launches=launches,
         plain_launches=plain, engine_launches=totals["launches"],
         chunk_launches=totals["prefill_chunk_launches"],
         peak_dense_slots_used=max(p["peak_dense_slots_used"]
                                   for p in passes.values()),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         warm=passes["warm"])
    return launches, eng, arrivals, sampling


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
    emit("profile", config=eng.cfg.name, steps=n_steps, batch=len(prompts),
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
    ssd_worst = phase_ssd_vs_plain()
    ssd_timing = phase_ssd_timing()
    mm_worst = phase_mm_vs_plain()
    mm_launches, cannon_worst, table1_live = phase_cannon()
    mm_timing = phase_mm_timing()
    flash_worst = phase_flash_vs_plain()
    flash_launches, flash_timing = phase_flash_timing()
    phase_reference()
    launches = {}
    for arch in ("qwen2-0.5b", "mamba2-780m"):
        counts, eng, prompts, sampling = phase_engine(arch)
        launches.update({k: n for k, n in counts.items() if n})
        phase_profile(eng, prompts, sampling)
        del eng
        torch.cuda.empty_cache()

    decode = timing[0]
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["paged_attention"],
        "max_abs_err": decode["max_abs_err"],
        "max_rel_err": max(w[0] for w in worst.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": "decode: B=8, L=1, Hq=14, kvh=2, hd=64, stride=16, bf16",
        "per_L_ms": {str(t["L"]): t["ms"] for t in timing},
    }]
    for name in ("ssd_chunk", "ssd_apply"):
        rows = [t for t in ssd_timing if t["kernel"] == name]
        top = rows[-1]                                    # L = 256
        kernels.append({
            "name": name, "route": "cuda", "source": SSD_SOURCE,
            "replaces": SSD_REPLACES[name], "launches": launches[name],
            "max_abs_err": ssd_worst[name][1],
            "max_rel_err": ssd_worst[name][0],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "device_ms": top["device_ms"],
            "shape": "B=8, L=256, H=48, P=64, N=128, G=1, bf16 x",
            "per_L_ms": {str(t["L"]): t["ms"] for t in rows},
            "per_L_device_ms": {str(t["L"]): t["device_ms"] for t in rows},
        })
    top = mm_timing[-1]               # the n = 8192 Cannon round
    kernels.append({
        "name": "cannon_mm", "route": "cuda", "source": MM_SOURCE,
        "replaces": MM_REPLACES, "launches": mm_launches,
        "max_abs_err": mm_worst[1], "max_rel_err": mm_worst[0],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "device_ms": top["device_ms"],
        "shape": top["shape"],
        "cannon_vs_fp64_rel_err": cannon_worst,
        "per_shape": {t["shape"]: {k: t[k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
            for t in mm_timing},
    })
    top = flash_timing[0]             # qwen2-0.5b prefill, B = 1
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": max([flash_worst[1]]
                           + [t["max_abs_err"] for t in flash_timing]),
        "max_rel_err": max([flash_worst[0]]
                           + [t["max_rel_err"] for t in flash_timing]),
        "elem_err": max([flash_worst[2]]
                        + [t["elem_err"] for t in flash_timing]),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "device_ms": top["device_ms"],
        "shape": f"{top['geometry']}, S={FLASH_S}, causal, bf16",
        "per_shape": {t["geometry"]: {k: t[k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
            for t in flash_timing},
    })
    emit("table1_summary", rows=[{k: r[k] for k in (
        "size", "hybrid_ms", "opencl_ms", "hybrid_wire_bytes",
        "opencl_wire_bytes", "bytes_ratio")} for r in table1_live])
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
