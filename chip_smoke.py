#!/usr/bin/env python3
"""Chip smoke test: repro_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — compile both CUDA libraries (paged attention; the two SSD-scan
   kernels) from the checkout's sources with nvcc for sm_90a, one nvcc
   each, started together;
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
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    mods = {"paged_attention": paged, "ssd_scan": ssd}
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
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
