#!/usr/bin/env python3
"""Chip smoke test: repro_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — compile the six CUDA libraries (paged attention; the SSD-scan
   kernels; the cannon_mm matmul; flash attention; the grouped GEMM; the
   symmetric heap) from
   the checkout's sources with nvcc for sm_90a, one nvcc each, started
   together; then fresh_thread: each library's first launch in a fresh
   process on a new thread (the grouped GEMM's also inside a backward, on
   the autograd engine's thread) gives the main thread's bits
   (``repro_torch.launch.fresh_thread``, thirteen cases at once, the
   symmetric heap's among them);
3. paged-attention kernel against its plain version on the card — random scrambled block
   tables with holes, qwen2-0.5b head geometry (14 q heads over 2 kv heads,
   hd 64, stride 16), B in {1, 8}, L in {1, 5, 16, 64, 256} (5: the
   speculative verify step at k = 4), bf16 and fp32
   arenas, contexts up to 512, plus hd 8 with two grid rows sharing the
   pages, B 1 decode at the end of a full 64-entry table (the bf16
   kernel's split over the table, every split busy), batch-8 decode
   on two grid rows where one sees no visible key (the all-masked merge:
   its m stays -1e30 and its l counts its keys) and qwen3-moe's geometry
   (64 q heads over 4 kv heads, group 16, hd 64 as the repo's config
   gives it; B 8, L in {1, 5, 16, 256}; and at hd 128, the published
   Qwen3-235B-A22B head size, L in {1, 16, 256}), and the full head
   geometries of stablelm-12b (32 q over 8 kv heads, hd 160) and qwen2-7b
   (28 over 4, hd 128: group 7), B in {1, 8}, L in {1, 5, 16, 64, 256};
   then timings at the main path's shapes (events and the kernel's device
   time, with the split count) against the plain version, one
   scaled_dot_product_attention call on the gathered K/V, and the least
   time the card could take, at qwen2-0.5b's geometry and at the two
   dense configs' (each over its own number of layer arenas);
4. SSD-scan kernels against their plain versions on the card — random
   inputs at the mamba2-780m geometry (48 heads x 64, state 128, 1 group)
   and the reduced one (8 x 16, state 16, 1 or 4 groups), B in {1, 8},
   L in {1, 5, 16, 64, 256}, one or two chunks, zero and non-zero initial
   state, padding columns with dt = 0, bf16 and fp32 x, packed and
   contiguous: the two passes, then the op ``ssd_scan`` at one chunk of
   every case on the route kernel.py::plan names (the fused launch for
   bf16, the two passes for fp32) against ``ssd_scan_fused_ref``; then
   timings against the plain versions and the least time the card could
   take: the fused scan and the two tensor-core (mma) passes at batch 8,
   L in {5, 16, 64, 256}, bf16, mamba2-780m geometry; the two CUDA-core
   (simt) passes at the fp32 reference configs' chunk and verify steps
   (batch 4, L 16 and 5, the reduced geometry);
5. end-to-end reference checks — the reduced qwen2, the reduced mamba2, a
   small hybrid (attention + mamba) config, the reduced qwen3-moe and the
   reduced jamba (attention, mamba and MoE layers) in fp32, served on the card
   and on the CPU (plain versions) from the same weights (fp32 takes the
   two SSD passes on their simt variant: their launches here are the ones
   the kernels line reports); each is also served with n-gram speculation
   on the card and on the CPU and without it on the card, with identical
   tokens, and the reduced qwen2 and qwen3-moe self-draft through
   DraftModelDrafter on their own weights, every draft token accepted; the
   MoE configs' experts take the grouped GEMM's fp32 (simt) variant, w1
   fused with its epilogue;
6. the engine at full width — qwen2-0.5b (24 layers, d_model 896, vocab
   151936, bf16), then mamba2-780m (48 layers, d_model 1536, 48 SSD heads,
   vocab 50280, bf16), each with random weights from seed 0: 8 requests
   served twice (cold, then warm through the prefix caches), then 8 fresh
   prompts of the same lengths arriving one per step — checking that
   every request ends with its 32 tokens, that no logits row is
   non-finite, and that the kernels carried every attention (qwen2) or
   mamba (mamba2: the fused SSD launch) layer of every launch that runs
   them, the plain versions none.  Each (bucket, L) step is captured once
   as a CUDA graph and replayed (``CommandQueue.build``): the queue must
   hold exactly one graph per step that ran, and the kernels' counts are
   added per replay;
7. graphs — the same engine, weights and passes on a queue that runs every
   step body eagerly (the engine before its steps were captured): each
   pass's greedy tokens and ``EngineStats`` must be identical;
8. profile — eight batch-8 decode steps of each model under
   torch.profiler, every one a replay: step wall time, device busy time
   and idle share, the top kernels; for mamba2 also one batch-8 len256
   chunked-prefill step (a replay): its wall time, device busy time and
   the SSD kernels' share of it; then decode_fixed — the fixed-batch
   decode path (``serve/decode.py::make_decode_step``, the JAX launcher's
   default) on the same weights: batch 8, a cache of 512 positions, 32
   greedy tokens from one first token a slot, qwen2-0.5b in gemv,
   batched and longctx (identical tokens, logits within 1e-6), mamba2-780m
   in gemv; the tokens held against the engine's on the same one-token
   prompts up to near-ties; the wall per token and the device busy time
   per step beside the engine's replayed decode step;
9. speculation — n-gram speculative decoding (k = 4) on each model, same
   weights and engine setting: eight repetitive prompts of the smoke's
   lengths, 32 greedy tokens, cold then warm, on a plain and on a
   speculative engine.  Gates: every request ends ``"length"`` with its
   32 tokens, no logits row (verify rows included) is non-finite, drafts
   were proposed and verified, proposed = accepted + rejected, launches =
   decode + prefill + verify, no page or slot left held, one graph per
   step that ran (``verify_bs{N}_len5`` among them), paged attention on
   every attention layer of every launch and the fused scan on every
   mamba layer of every chunk and verify launch with the plain versions
   at 0, for mamba2 at least one restore per rollback, and greedy tokens
   equal to the plain engine's except where the plain run's top-2 margin
   is a near-tie (``phase_speculation``); then the same workload on the
   eager queue (identical tokens and ``EngineStats``) and three replayed
   batch-8 verify steps under torch.profiler;
10. service — the asyncio ``GenerateService`` over qwen2-0.5b at full
   width on the same weights: a reference engine's ``generate()`` over 32
   mixed-length requests (its committed rows recorded) and its warm
   request rate R; a cold service on a fresh engine (every step graph
   captured on the service's engine thread), 32 clients at Poisson
   arrivals of 0.5 R, fifo, whose streams must give the reference tokens
   (or leave them only at a near-tie of the reference row, the rule of
   phase 9) and end ``"length"`` with 32; then, warm, 32 requests at
   0.5 R and 64 at 2 R, fifo and ``deadline`` at a TTFT SLO of 4x the
   warm 0.5 R pass's mean TTFT, each pass leaving no page or slot held
   and every shed stream empty.  Printed per pass: completed, shed,
   rejected, TTFT p50/p99, ITL mean, tokens/s and the engine's launches;
11. resilience — on qwen2-0.5b and mamba2-780m: an armed guard with no
   fault gives the unguarded engine's tokens and ``EngineStats`` exactly,
   and both serve warm in turns for the step wall with and without the
   guard; tests/test_chaos.py's seeded soak (launch, device, nan, pool,
   stall) keeps every request that is not quarantined on the unguarded
   tokens (the near-tie rule), drains the pools and accounts for every
   replay; ``drain_to`` mid-generation restored on a fresh engine
   continues to the unguarded tokens (the near-tie rule); in fp32 (the
   same weights widened) the same drain and a drain with a verify round
   in flight (``ReplayDrafter``), restored on fresh engines, give the
   uninterrupted tokens exactly.
   Every phase 10 and 11 engine's steps are replays of graphs whose
   kernels are counted: paged attention on every attention layer of every
   launch, the fused scan (bf16) or the two simt passes (fp32) on every
   mamba layer of every chunk and verify launch, the plain versions never;
12. dense_wide: qwen2-7b (28 layers, d_model 3584, 28 q over 4 kv heads,
   hd 128, QKV bias, vocab 152064; 15.2 GB) and then stablelm-12b (40
   layers, d_model 5120, 32 over 8 heads, hd 160, layernorm, vocab 100352;
   24.3 GB) at full width in bf16, random weights from seed 0, each on an
   emptied cache, through phase 6's engine setting, workload and gates
   (paged attention on every attention layer of every launch, the plain
   version never, one graph per step that ran), then eight replayed
   batch-8 decode steps of each under torch.profiler with paged
   attention's share; then vlm — pixtral-12b at full width and depth (40
   layers, d_model 5120, 32 q over 8 kv heads, hd 160, vocab 131072; 25.6
   GB) through the same engine workload and gates on its text (its
   ``vis_proj`` unused, as in the JAX engine) and the decode profile,
   ``make_prefill`` on batch 2 of 1024 stub patch embeddings and 512 text
   tokens (finite logits that the patches move), and a training run at 12
   of its 40 layers (fp32 moments, 2 x (1024 patches + 1024 tokens));
13. supervisor: the crash-safe ReplicaSupervisor on qwen2-0.5b and
   mamba2-780m at full width, its workers spawned processes on this card
   that load the kernels phase 2 built, the parent holding no engine
   while they run: a pass in fp32 and one in bf16 of each, each pass
   with the failure SUPERVISED names at a fixed token count: in fp32 one
   corrupted checkpoint followed by an injected ``process_kill`` (the
   restore falls back to the previous good checkpoint), in bf16 a
   ``kill_replica`` call.  Gates: every
   stream ends "length" with 32 tokens, none duplicated or dropped, the
   last worker holds no page, slot or request, one failover for each
   failure and the corrupted checkpoint seen where one was injected, no
   watchdog trip, each worker's own kernel counts (``("stats",)``) as in
   phase 6 with the plain versions at 0 and nothing built; in fp32 the
   streams equal an in-process uninterrupted run's tokens exactly and no
   replayed token diverges.  Reported: each failover's time from the kill
   to the worker's exit, to the next worker's ready and to the first
   resumed token, with its spawn, build and capture parts and the card's
   free memory at ready; the replay divergences (replayed tokens below a
   stream's high-water mark that differ from the delivered ones, which
   the dedup drops) and, in bf16, each stream's first divergence from
   the uninterrupted run with the reference's top-2 margin there;
14. grid — on an emptied cache, the symmetric heap's two kernels
   (``kernels/shmem_heap``: put, and reduce_slots, the sum or max over a
   collective's slots in fp32) against their plain versions on a heap of
   this process, bit for bit, at ragged edges and at qwen2-0.5b's gate|up
   message of a decode step and of a len256 chunk (fp32 and bf16), and
   timed at those messages (CUDA events and the profiler's device time)
   against the plain version, ``Tensor.copy_`` / ``torch.sum`` and the
   bytes bound; then, in one spawn of four PE processes on this card
   (``serve/engine/grid.py``: heaps mapped through CUDA IPC, barriers on
   the host, steps broadcast over gloo, every step eager), after the parts
   of one collective are timed, four prompts ([5, 40, 100, 300], 16
   greedy tokens) on qwen2-0.5b (24 layers), mamba2-780m (48 layers)
   and qwen3-moe (full width, 2 of 94 layers, capacity_factor 4 =
   n_pes), each in fp32 and in bf16 (served twice under torch.profiler,
   the second pass timed), and qwen2-0.5b and mamba2-780m in bf16 at
   their first 1 and 2 layers, beside the 1x1 engine on the same seed-0
   weights; qwen3-moe in
   bf16 at its capacity_factor 1.25 (the share of dropped pairs); the
   reduced jamba in fp32 at capacity_factor 4.
   Gates: four PEs on CUDA with CUDA-IPC heaps and gloo, no plain
   version, on every PE paged attention on every attention layer of
   every step at ``qrows`` 2, the fused SSD scan (bf16) or its two simt
   passes (fp32) on every mamba layer of every chunk step, both grouped
   GEMMs on every MoE layer of every step, the heap kernels' launches as
   the steps' puts and reductions imply, fp32 tokens equal to the 1x1
   engine's, bf16 first-step logits within GRID_BF16_TOL of the 1x1
   engine's per job, every step's heap bytes equal to the count
   reckoned from the shapes, nothing dropped at capacity_factor 4, and
   the phase under GRID_PHASE_S.  Printed per job: the heap's size, wall
   per step, collectives per step, barrier-wait share per PE, heap bytes
   per step, device busy per PE and step, tokens/s against the 1x1
   engine, the dense-slot commands PE 0 sent, the MoE pairs dropped;
14b. grid_forward — the blocked layout on the same 2x2 grid
   (``launch/grid_run.py``; its jobs run in the grid phase's spawn, after
   the serving jobs, so the PEs start once: ``phase_grids``):
   ``make_loss_fn`` and
   ``make_prefill`` on batch 2 x 1024 tokens (512 a grid row), once each,
   on qwen2-0.5b (24 layers) in fp32 under cannon, cannon_opt, allgather
   and SUMMA and in bf16 under cannon and cannon_opt, mamba2-780m (48
   layers, the sequence-sharded block: 4 scan chunks a row, the halo and
   the state relay) in fp32 under cannon and cannon_opt and in bf16 under
   cannon, the reduced jamba in fp32 under cannon and cannon_opt; then
   ``make_decode_step(mode="batched")`` under Cannon (batch 8, 4 a row,
   s_max 512, 8 greedy tokens from one random token a row) on
   qwen2-0.5b in fp32 and bf16 and mamba2-780m in fp32; each beside the
   port's 1x1 on the same seed-0 weights.  Gates on every PE: fp32 loss,
   prefill logits and first decode logits within GRID_FWD_TOL of the
   1x1's, fp32 decode tokens equal, the fp32 strategies within
   GRID_FWD_TOL of each other, bf16 logits within GRID_FWD_BF16_TOL;
   every forward's and decode step's heap bytes as reckoned from the
   shapes; cannon_mm on every distributed GEMM (q launches a Cannon,
   crot or SUMMA GEMM, one an allgather one), the SSD passes on every
   mamba layer of every forward (``mma`` in bf16, ``simt`` in fp32), the
   grouped GEMMs on every MoE layer, no plain version.  Printed per job
   and strategy: ms per forward and per decode step, collectives, heap
   bytes per PE, barrier-wait share, cannon_mm's variants;
14c. grid_train — in grid_forward's spawn, the training step on the grid
   (``TrainJob``: ``make_train_step`` with a grid ``pctx``, its backward
   through every put and collective): GRID_TRAIN_STEPS AdamW steps at lr
   1e-3, eps 1e-6, remat on, on one batch of 2 x 1024 tokens, of
   qwen2-0.5b (24 layers) in fp32 under cannon and cannon_opt and in bf16
   under cannon_opt, mamba2-780m at 8 of its 48 layers in fp32 under
   cannon, and qwen3-moe at 2 layers in bf16 with 8-bit moments under
   cannon_opt, each beside the port's 1x1 step on the same seed-0 weights
   and batch.  Gates on every PE: heap bytes and collectives of every
   step as ``train_messages`` reckons them; cannon_mm on every GEMM of the
   forward, the recompute and both backward products, the grouped GEMM's
   forward, dgrad and wgrad on every MoE layer, no plain version; fp32
   loss within 1e-5 and grad_norm within 1e-4 of q*r = 4 times the 1x1's
   (JAX's grid step carries that factor), the second step and the
   parameter blocks (within 2e-5 of the 1x1's cut by ``shard_params``;
   mamba2's within GRID_TRAIN_DEEP_PARAMS_TOL) where the 1x1's first norm
   exceeds grad_clip, so both clip; bf16 within GRID_TRAIN_BF16_TOL.  Printed per job (a ``grid_train_run``
   line each, then a ``grid_train`` line): ms per step, collectives per
   step, heap MB a PE, the barrier-wait share, and the 1x1's ms per step;
15. the engine at full width on an MoE model, last and after the cache is
   emptied — qwen3-moe-235b-a22b at the repo config's full width (d_model
   4096, 64 q heads over 4 kv heads, hd 64, qk_norm, 128 experts top-8 of
   d_ff_expert 1536, vocab 151936, bf16; the config sets no head_dim, so
   hd is 4096 / 64, where the published model's head_dim is 128, and its
   attention projections are half the published size) with its depth cut
   to 8 of its 94
   layers (41.7 GB of weights: all 94 are 464 GB), random weights from
   seed 0, through the same engine setting, workload and phases as 6-8:
   engine (gates: paged attention on every attention layer of every
   launch, the grouped GEMM on 2 x MoE layers of every launch: w1 with
   its fused silu x up epilogue, then w2, each launch on the variant
   kernel.py::plan names for its step's rows, every len256 step on
   wgmma_tma; the plain versions never), graphs, profile (batch-8 decode,
   and one batch-8 len256 prefill step with the grouped GEMM's share), and
   decode_fixed in gemv (the grouped GEMM twice per MoE layer and step);
16. the kernels line, the card line, and the result line.

Between 4 and 5 run the phases of the paper core and the last two
kernels:

* mm_vs_plain — the cannon_mm matmul kernels against their plain version
  (tests/test_kernels.py shapes, ragged shapes, 16-PE stacks, transposed
  strides, the fast variants' ragged edges; fp32 and bf16; out_dtype fp32
  and default), each case on the variant kernel.py::plan names, all four
  variants met, and the backward against autograd through the plain
  version;
* cannon — every strategy (Cannon natural and pre-skewed, C-rotating,
  allgather, SUMMA, gemv2d) on the emulated 4x4 grid at the Table 1 sizes
  (n = 128, 512, 4096, 8192 fp32; qwen2-0.5b's 4096 x 896 x 4864 MLP
  up-projection in bf16) against a host fp64 product, with the matmul
  kernel counted (q launches per Cannon and SUMMA call, 1 per allgather
  and gemv2d call, the plain version never; every bf16 launch on
  wgmma_tma, every fp32 launch on f32_vec); then the Table 1 rows
  (launch/table1.py: hybrid against allgather through the CommandQueue);
* mm_timing — the matmul at 4096^3 bf16 and fp32, at the n = 8192
  Cannon round (16 x 2048^3 fp32) and at the bf16 Cannon round of the
  4096x896x4864 GEMM (16 x (1024x224)@(224x1216), fp32 out) against its
  plain version, one torch.matmul (torch.bmm) and its bound;
* flash_vs_plain and flash_timing — the flash-attention kernel against
  its plain version (tests/test_kernels.py shapes, ragged tails, an
  offset block), then the op at qwen2-0.5b's and qwen3-0.6b's prefill
  geometries (S 4096, B 1 and 4, causal, bf16), counted, and timed
  against the plain version, scaled_dot_product_attention and the bound;
* gmm_vs_plain and gmm_timing — the grouped GEMM and its first product
  fused with the silu x up epilogue (``grouped_mm_swiglu``) against their
  plain versions, every variant (bf16 mma and wgmma_tma, forced whatever
  plan would pick; fp32 simt), at qwen3-moe's two expert products
  (K 4096 -> N 3072 and K 1536 -> N 4096, 128 experts, rows routed top-8)
  at M = T*k of batch-8 decode (64), verify at k = 4 (320) and the
  len16/64/256 chunks (1024, 4096, 16384), bf16 and (decode, verify)
  fp32, and at edge cases (empty experts, every row in one expert, one
  expert of 600 rows, ragged M, K and N, rows past offsets[E] and before
  offsets[0]); then each variant timed at every stage against the plain
  version, one torch._grouped_mm call where the card's PyTorch has it,
  and the bound, and the fused w1 against the unfused kernel and the
  torch lines it replaces;
* gmm_grad_vs_plain and gmm_grad_timing — the grouped GEMM's backward
  (dgrad dy w[e]^T and wgrad x[rows]^T dy[rows]; bf16 wgmma_tma and fp32
  simt; and the swiglu op's backward through its autograd function)
  against their
  plain versions at qwen3-moe's two products, at batch-8 decode rows (64)
  and a training step's (65536 = batch 8 x len 1024 x top-8), uniform and
  on skewed routing with 16 empty experts and rows past offsets[E], bf16
  and fp32, and at the forward's edge cases; rows of no expert and
  experts with no rows exact zeros, two calls the same bits; then each
  timed (events ms, and the kernel's device ms by name from
  torch.profiler) against the plain version, one torch._grouped_mm call
  (else the per-expert torch.matmul loop) and the bound;
* train — qwen2-0.5b and mamba2-780m at full width and depth, and
  qwen3-moe-235b-a22b at full width with 2 of its 94 layers and 8-bit
  moments, through the functions launch/train.py calls: 6 AdamW steps on
  one batch of 8 x 1024 tokens at the config's vocab, peak lr 1e-4.
  Gates: finite losses and norms, the last loss below the first, every
  parameter on the card, and for qwen3-moe the grouped GEMM's forward
  (twice: the recomputed layer), the swiglu backward's recomputed
  product, dgrad and wgrad launched as its layers and steps imply (dgrad
  and wgrad on their wgmma_tma variant only), the plain versions never.
  train_profile: steps 2 and 3 of the gated qwen3-moe run under
  torch.profiler: device busy, idle share, the top kernels, and the
  grouped GEMM's forward, dgrad and wgrad shares of busy, where the trace
  kept every record.  Then two probes at lr 3e-4, reported: qwen3-moe
  with 8-bit moments (2 layers) and with fp32 moments (1 layer, what
  fits), which show the reference's 8-bit moments (TRAIN_LR's comment).
  Printed: step wall ms, tokens/s, peak memory, the losses, beside the
  card's name and power limit;
* train_resume — ``python -m repro_torch.launch.train --arch qwen2-0.5b
  --full --layers 4 --steps 6 --ckpt-every 3`` (deterministic algorithms
  on) run straight and, beside it, stopped by a fault drill at step 4 past
  its retry budget, then started again from the step-2 checkpoint: the
  resumed steps give the straight run's losses bit for bit.  Beside them
  grid_train_resume: the same launcher with ``--grid 2x2 --strategy
  cannon_opt --seq-len 1024 --global-batch 2 --steps 4 --ckpt-every 2``
  (bf16, fp32 moments), straight and stopped at step 3, then resumed from
  the step-1 checkpoint (the grid's stored form, meta grid [2, 2]): steps
  2-3 bit for bit, every PE the same losses, cannon_mm and the heap
  kernels as reckoned and no plain version, and the 1x1 port's loss on
  that checkpoint within the bf16 loss gate of the grid's step 2;
* dryrun — ``python -m repro_torch.launch.dryrun --all`` in the
  background (the 40 arch x shape cells counted on the meta device,
  DRYRUN_JOBS processes; each cell's line printed) while three cells run
  on the card through ``dryrun.verify_cell`` (DRYRUN_VERIFY: qwen2-0.5b
  decode_32k at full depth, qwen3-moe train_4k at 2 layers with 8-bit
  moments, mamba2-780m prefill_32k): each measured peak within 15 % of
  the reckoned one, counted FLOPs over the wall below the card's peak, a
  cell that fits with max_layers at least its depth;
* examples — ``repro_torch.examples`` quickstart, serve_decode and
  train_lm in this process at small sizes: cannon_mm and paged_attention
  launched, no plain version, train_lm's loss falling and a second run
  resuming from its checkpoint;
* encdec — whisper-base at full width and depth (6 encoder and 6 decoder
  layers): the encoder over 1500 stub frames for batch 8 fills every
  decoder layer's cross-K/V cache (``fill_cross_cache``), 32 greedy
  fixed-batch decode tokens; teacher-forced, the decode logits against
  ``forward`` and ``make_prefill`` on the same tokens and frames (bf16
  within 2^-3 and greedy agreeing up to near-ties; fp32 within 1e-4);
  then a training run of 6 steps on 8 x 448 tokens with their frames.

It imports nothing of JAX and nothing of the ``repro`` package.  Without a
card, or outside a checkout that holds ``src/repro_torch``, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
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
                "ssd_apply": "src/repro/kernels/ssd_scan/kernel.py:117",
                "ssd_scan_fused":
                    "src/repro/kernels/ssd_scan/kernel.py:74,117"}
# the SSD kernels' names in a profile, per wrapper
SSD_KERNELS = {"ssd_chunk": ("chunk_mma_kernel", "chunk_simt_kernel"),
               "ssd_apply": ("apply_mma_kernel", "apply_simt_kernel"),
               "ssd_scan_fused": ("fused_mma_kernel",)}
MM_SOURCE = "src/repro_torch/kernels/cannon_mm/csrc/cannon_mm.cu"
MM_REPLACES = "src/repro/kernels/cannon_mm/kernel.py:51"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:75"
GMM_SOURCE = "src/repro_torch/kernels/grouped_mm/csrc/grouped_mm.cu"
GMM_REPLACES = "src/repro/models/moe.py:116,120"
GMM_SWIGLU_REPLACES = "src/repro/models/moe.py:116-119"
# each grouped-GEMM entry's headline shape in the kernels line
GMM_HEADLINE = {"grouped_mm": "w2 len256", "grouped_mm_swiglu": "w1 len256"}
HBM_BYTES_S = 3.35e12                       # H100 SXM, data sheet
# the device of the training, fixed-batch decode, encdec and vlm phases
DEV = "cuda"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PROMPT_LENS = [5, 17, 40, 64, 100, 200, 300, 33]
MAX_TOKENS = 32
SPEC_K = 4                  # draft tokens a verify step checks: L = k + 1
# (q heads, kv heads, head size) of the dense configs served at full width
DENSE_GEOMS = {"stablelm-12b": (32, 8, 160), "qwen2-7b": (28, 4, 128)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


LAST_PHASE = ["none"]          # the last phase emitted, named on failure


def emit(phase, **kw):
    LAST_PHASE[0] = phase
    print(json.dumps({"phase": phase, **kw}), flush=True)


def rel_err(want, got):
    want, got = want.double(), got.double()
    return float((want - got).abs().max() / want.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# Phase 3 inputs: block tables shaped like the engine's.
# ---------------------------------------------------------------------------

def make_case(rng, *, B, L, hd, Hq, kvh, stride, s_max, dtype,
              qrows=1, ctx=None, start=None, holes=True, layers=1,
              row0_masked=False):
    """Random q, per-layer K/V arenas (one per grid row), a scrambled table
    covering each slot's context, and query positions.  ``ctx[b]`` is the
    number of positions slot b's table covers; its L query rows sit at
    ``start[b] + arange(L)``.  ``row0_masked`` (qrows 2): each slot's
    entries on grid row 1 come first, and its rows sit below every label
    of grid row 0, which sees no visible key."""
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
        if row0_masked:
            pages = table[b, :n].copy()
            table[b, :n] = np.concatenate([pages[pages % 2 == 1],
                                           pages[pages % 2 == 0]])
            start[b] = int(rng.integers(0, (pages % 2 == 1).sum() * stride
                                        - L + 1))
    n_loc = -(-n_blocks // qrows)
    q_pos = (torch.tensor(start, dtype=torch.int32)[:, None]
             + torch.arange(L, dtype=torch.int32)[None, :])
    q = torch.from_numpy(rng.standard_normal((B, Hq, L, hd), "float32"))
    # the arenas are drawn on the card, from a generator seeded by ``rng``:
    # on the host, 40 layers' arenas at stablelm-12b's geometry take tens
    # of seconds a case
    gen = torch.Generator("cuda").manual_seed(int(rng.integers(2 ** 62)))

    def arena():
        return torch.randn((n_loc, stride, kvh, hd), generator=gen,
                           device="cuda").to(dtype)
    arenas = [[(arena(), arena()) for _ in range(qrows)]
              for _ in range(layers)]
    return dict(q=q.to("cuda", dtype), arenas=arenas,
                table=torch.from_numpy(table).cuda(), q_pos=q_pos.cuda(),
                stride=stride, qrows=qrows)


def n_split(c):
    """Blocks per tile over the block table, as the wrapper plans them."""
    from repro_torch.kernels.paged_attention.kernel import launch_plan
    q, kc = c["q"], c["arenas"][0][0][0]
    B, Hq, L, hd = q.shape
    return launch_plan(B, Hq, L, hd, kc.shape[2], c["table"].shape[1],
                       c["stride"], q.dtype == torch.bfloat16)[0]


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
         count=torch.cuda.device_count(), nvidia_smi=smi,
         total_memory=torch.cuda.get_device_properties(0).total_memory)
    return smi


def phase_build():
    """One nvcc per source, all started together."""
    from repro_torch.kernels.cannon_mm import kernel as mm
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.grouped_mm import kernel as gmm
    from repro_torch.kernels.paged_attention import kernel as paged
    from repro_torch.kernels.shmem_heap import kernel as heap
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    mods = {"paged_attention": paged, "ssd_scan": ssd, "cannon_mm": mm,
            "flash_attention": flash, "grouped_mm": gmm, "shmem_heap": heap}
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
                  dtype=dt) for B in (1, 8) for L in (1, 5, 16, 64, 256)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [dict(B=3, L=L, hd=8, Hq=8, kvh=2, stride=4, s_max=64, dtype=dt,
                   qrows=2) for L in (1, 8)
              for dt in (torch.bfloat16, torch.float32)]
    # the bf16 kernel's split over the table: B 1 decode at the end of a
    # full 64-entry table (every split busy), and batch-8 decode on two
    # grid rows where row 0 sees no visible key (the all-masked merge)
    cases += [dict(B=1, L=1, hd=64, Hq=14, kvh=2, stride=16, s_max=1024,
                   dtype=dt, ctx=[1024], start=[1023], holes=False)
              for dt in (torch.bfloat16, torch.float32)]
    cases += [dict(B=8, L=1, hd=64, Hq=14, kvh=2, stride=16, s_max=512,
                   dtype=dt, qrows=2, ctx=[512] * 8, start=[0] * 8,
                   holes=False, row0_masked=True)
              for dt in (torch.bfloat16, torch.float32)]
    # qwen3-moe-235b-a22b: 64 q heads over 4 kv heads (group 16: the bf16
    # tile holds 8 query positions), hd 64 as the repo's config gives it,
    # and hd 128, the published model's head_dim
    cases += [dict(B=8, L=L, hd=64, Hq=64, kvh=4, stride=16, s_max=512,
                   dtype=dt) for L in (1, 5, 16, 256)
              for dt in (torch.bfloat16, torch.float32)]
    cases += [dict(B=8, L=L, hd=128, Hq=64, kvh=4, stride=16, s_max=512,
                   dtype=dt) for L in (1, 16, 256)
              for dt in (torch.bfloat16, torch.float32)]
    # the dense configs' full geometries: stablelm-12b (32 q over 8 kv
    # heads, hd 160) and qwen2-7b (28 over 4, hd 128: group 7, 7 warps a
    # 16-position tile)
    cases += [dict(B=B, L=L, hd=hd, Hq=Hq, kvh=kvh, stride=16, s_max=512,
                   dtype=dt)
              for (Hq, kvh, hd) in DENSE_GEOMS.values() for B in (1, 8)
              for L in (1, 5, 16, 64, 256)
              for dt in (torch.bfloat16, torch.float32)]
    for spec in cases:
        c = make_case(rng, **spec)
        want = merge_rows(run_rows(paged_attention_ref, c))
        parts = run_rows(paged_attention_cuda, c)
        got = merge_rows(parts)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"non-finite output {spec}")
        err = rel_err(want, got)
        abs_err = float((want - got).abs().max())
        name = str(spec["dtype"]).split(".")[-1]
        if spec.get("row0_masked"):
            # row 0's partials: m stays NEG_INF, l counts its owned keys
            m0, l0, _ = parts[0]
            t = c["table"]
            owned = ((t >= 0) & (t % 2 == 0)).sum(1) * c["stride"]
            check(bool((m0 == -1e30).all()) and torch.equal(
                l0, owned.to(l0)[:, None, None].expand_as(l0)),
                f"all-masked grid row: m or l off {spec}")
        emit("kernel_vs_plain", B=spec["B"], L=spec["L"], hd=spec["hd"],
             Hq=spec["Hq"], kvh=spec["kvh"],
             qrows=spec.get("qrows", 1), dtype=name, max_rel_err=err,
             max_abs_err=abs_err, tol=tol[spec["dtype"]],
             n_split=n_split(c), all_masked_row0=bool(
                 spec.get("row0_masked")))
        check(err <= tol[spec["dtype"]], f"kernel disagrees: {spec} rel {err}")
        w = worst.setdefault(name, [0.0, 0.0])
        w[0], w[1] = max(w[0], err), max(w[1], abs_err)
    return worst


def phase_timing(n_layers, Hq=14, kvh=2, hd=64, geometry="qwen2-0.5b"):
    """Kernel, plain and library times at the main path's shapes: batch 8
    of the smoke workload, bf16, cycling over ``n_layers`` arenas as the
    engine's layers do, at one model's head geometry.  Decode and verify
    (L = 5) rows sit 16 tokens into generation; chunk rows are each
    prompt's first chunk.  ``ms`` is CUDA events around back-to-back
    wrapper calls (the wrapper's host time when that is the longer);
    ``device_ms`` is the kernel's own time on the card."""
    from repro_torch.kernels.paged_attention import (merge_rows,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    rng = np.random.default_rng(1)
    rows = []
    for L in (1, SPEC_K + 1, 16, 64, 256):
        if L in (1, SPEC_K + 1):        # decode, and a verify at k = 4
            ctx = [p + 16 + L for p in PROMPT_LENS]
            start = [p + 16 for p in PROMPT_LENS]
        else:
            ctx = [p + 1 for p in PROMPT_LENS]
            start = [0] * len(PROMPT_LENS)
        c = make_case(rng, B=8, L=L, hd=hd, Hq=Hq, kvh=kvh, stride=16,
                      s_max=512, dtype=torch.bfloat16, ctx=ctx, start=start,
                      holes=False, layers=n_layers)

        def kern(i, c=c):
            run_rows(paged_attention_cuda, c, i % n_layers)

        def plain(i, c=c):
            run_rows(paged_attention_ref, c, i % n_layers)

        libs = [library_call(c, li) for li in range(n_layers)]
        want = merge_rows(run_rows(paged_attention_ref, c))
        got = merge_rows(run_rows(paged_attention_cuda, c))
        t = dict(geometry=geometry, Hq=Hq, kvh=kvh, hd=hd, L=L, B=8,
                 n_split=n_split(c),
                 ms=cuda_ms(kern, 4 * n_layers),
                 device_ms=device_ms(kern, n_layers, ("paged_",)),
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
REDUCED_GEOM = dict(H=8, P=16, G=1, N=16)           # reduced mamba2-780m
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


def ssd_fused_errors(ops):
    """The op ``ssd_scan`` on one chunk of ``ops``, on the card, against
    ``ssd_scan_fused_ref`` on the same inputs; checks that the kernels of
    the route kernel.py::plan names launched once each and no other SSD
    kernel did.  Returns (route, {output: (max rel err, max abs err)})."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import plan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_fused_ref
    x, dt, A, Bm, Cm, s0 = ops
    S = x.shape[1]
    rt = plan(x, Bm, Cm, chunk=S).route
    ran = ("ssd_scan_fused",) if rt == "fused" else ("ssd_chunk",
                                                     "ssd_apply")
    kerns = {k: kern for k, (kern, _) in kernel_counters().items()
             if k in SSD_KERNELS}
    before = {k: kern.launches for k, kern in kerns.items()}
    got = ssd_scan(x, dt, A, Bm, Cm, s0, chunk=S)
    for k, kern in kerns.items():
        check(kern.launches - before[k] == (k in ran),
              f"ssd_scan on route {rt}: {k} launched "
              f"{kern.launches - before[k]} times")
    want = ssd_scan_fused_ref(x, dt, A, Bm, Cm, s0, chunk=S)
    torch.cuda.synchronize()
    out = {}
    for name, w, g in zip(("y", "final"), want, got):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
              f"{w.dtype}")
        check(bool(torch.isfinite(g).all()), f"non-finite {name}")
        out[name] = (rel_err(w, g), float((w.double() - g.double())
                                          .abs().max()))
    return rt, out


def phase_ssd_vs_plain():
    """The SSD kernels against their plain versions over the cases of the
    main path and the reduced geometry: the two passes on each case, then
    the op at one chunk of the same geometry (fresh inputs) against the
    fused plain version.  Tolerances (max abs difference over max abs
    value): y_intra and y 1e-4 with fp32 x, 1e-2 with bf16 x (each rounded
    to bf16: a last-bit flip is 2^-8 of an element); states, cumexp and
    the final state, fp32 in all, 1e-4 (the cumsum of dt * A and the sums
    over s and n run in another order than torch).  Half the cases hand x,
    B and C over as slices of one packed tensor, the rest contiguous.
    Returns the worst (rel, abs) error per ``"kernel/variant"``."""
    from repro_torch.kernels.ssd_scan.kernel import plan
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
    # the verify step at k = 4: one chunk of 5, zero and non-zero state
    for B in (1, 8):
        for init in (False, True):
            for dt in (torch.bfloat16, torch.float32):
                cases.append(dict(B=B, L=SPEC_K + 1, nc=1, dtype=dt,
                                  pad=int(B == 1), init=init, **MAMBA2_GEOM))
    worst = {}
    for i, c in enumerate(cases):
        # each bf16/fp32 pair of cases runs one packed, the other
        # contiguous, alternating which from pair to pair
        c["packed"] = (i + i // 2) % 2 == 0
        ops = ssd_inputs(rng, B=c["B"], S=c["L"] * c["nc"], H=c["H"],
                         P=c["P"], G=c["G"], N=c["N"], dtype=c["dtype"],
                         pad=c["pad"], init=c["init"], packed=c["packed"])
        var = plan(ops[0], ops[3], ops[4], chunk=c["L"]).variant
        errs = ssd_case_errors(ops, c["L"])
        name = str(c["dtype"]).split(".")[-1]
        tol = {"y_intra": SSD_TOL[c["dtype"]], "y": SSD_TOL[c["dtype"]],
               "states": 1e-4, "cumexp": 1e-4}
        emit("ssd_vs_plain", **{k: v for k, v in c.items() if k != "dtype"},
             dtype=name, variant=var,
             max_rel_err={k: e[0] for k, e in errs.items()},
             max_abs_err={k: e[1] for k, e in errs.items()}, tol=tol)
        for k, (rel, abs_) in errs.items():
            check(rel <= tol[k], f"ssd kernels disagree on {k}: {c} "
                  f"rel {rel}")
            kern = "ssd_apply" if k == "y" else "ssd_chunk"
            w = worst.setdefault(f"{kern}/{var}", [0.0, 0.0])
            w[0], w[1] = max(w[0], rel), max(w[1], abs_)
        ops = ssd_inputs(rng, B=c["B"], S=c["L"], H=c["H"], P=c["P"],
                         G=c["G"], N=c["N"], dtype=c["dtype"], pad=c["pad"],
                         init=c["init"], packed=c["packed"])
        rt, errs = ssd_fused_errors(ops)
        tol = {"y": SSD_TOL[c["dtype"]], "final": 1e-4}
        emit("ssd_fused_vs_plain", **{k: v for k, v in c.items()
                                      if k not in ("dtype", "nc")},
             nc=1, dtype=name, route=rt,
             max_rel_err={k: e[0] for k, e in errs.items()},
             max_abs_err={k: e[1] for k, e in errs.items()}, tol=tol)
        for k, (rel, abs_) in errs.items():
            check(rel <= tol[k], f"ssd_scan ({rt}) disagrees with the "
                  f"fused plain version on {k}: {c} rel {rel}")
            kern = "ssd_scan_fused/mma" if rt == "fused" else \
                f"{'ssd_apply' if k == 'y' else 'ssd_chunk'}/{var}"
            w = worst.setdefault(kern, [0.0, 0.0])
            w[0], w[1] = max(w[0], rel), max(w[1], abs_)
    check("ssd_scan_fused/mma" in worst, "no case took the fused route")
    return worst


def ssd_bound(B, nc, L, H, P, G, N, esz):
    """Least time of each kernel on these inputs: every input read once
    and every output written once, against 3.35 TB/s; against that, the
    matrix products the function needs at the peak of its operands' type
    (bf16 x: the tensor cores' 989 TFLOP/s; fp32 x: 67 TFLOP/s) plus its
    elementwise work at the fp32 peak.  Products: the causal half of the
    scores C.B (per group), y_intra and the chunk states in pass 1;
    C.state_in in pass 2.  Elementwise: the decayed weights (an exp and two
    products a pair s <= t), sdecay * B, pass 2's scale and add, and the
    fused scan's exp(cum_last) * init + state.  The fused scan (nc = 1)
    reads x, dt, A, B, C and init and writes y and the final state."""
    S, tri = nc * L, L * (L + 1) // 2
    x_b, dt_b = B * S * H * P * esz, B * S * H * 4
    bc_b, st_b = 2 * B * S * G * N * esz, B * nc * H * N * P * 4
    chunk_mat = B * nc * (2 * G * N * tri + 2 * H * P * tri
                          + 2 * H * N * P * L)
    chunk_ew = B * nc * (3 * H * tri + H * N * L)
    apply_mat, apply_ew = 2 * B * S * H * P * N, 2 * B * S * H * P
    work = {"ssd_chunk": (2 * x_b + 2 * dt_b + H * 4 + bc_b + st_b,
                          chunk_mat, chunk_ew),
            "ssd_apply": (2 * x_b + bc_b // 2 + dt_b + st_b, apply_mat,
                          apply_ew),
            "ssd_scan_fused": (2 * x_b + dt_b + H * 4 + bc_b
                               + 2 * B * H * N * P * 4,
                               chunk_mat + apply_mat,
                               chunk_ew + apply_ew + 2 * B * H * N * P)}
    peak = PEAK_FLOPS["bfloat16" if esz == 2 else "float32"]
    out = {}
    for name, (by, mat, ew) in work.items():
        tb = by / HBM_BYTES_S * 1e3
        to = (mat / peak + ew / PEAK_FLOPS["float32"]) * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


# tiny kernels that open every profiled window of device_ms, busy_ms and
# train_profile.  Late in a process the trace loses the first kernel
# records of a window, which kineto counts as out of range, more of them
# the older the process (PERF.md §7 (14)).  These take that loss instead
# of the kernels measured; a window that lost more is taken again.
PROFILE_LEAD_IN = 64
PROFILE_TRIES = 3
# (seconds into the script, lead-in records lost, every other record kept)
# of each profiled window, printed as the profiler_records line
PROFILE_WINDOWS = []
T_START = [time.perf_counter()]


def profiler():
    """A torch.profiler over the CPU and the card, not yet started."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def lead_in():
    for _ in range(PROFILE_LEAD_IN):
        torch.cuda._sleep(1)


def kernel_rows(prof):
    """(rows, kept) of a window that ``lead_in`` opened: the profiled CUDA
    rows other than the lead-in's, and whether every kernel launched after
    it kept its record (a lead-in record is left, and the other kernel
    records match the launch calls: cudaLaunchKernel, cuLaunchKernelEx
    and the like; memcpy and memset records stand apart)."""
    from torch.autograd import DeviceType
    rows, spins, kernels, launches = [], 0, 0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" in e.key:
                spins += e.count
                continue
            rows.append(e)
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
        elif "LaunchKernel" in e.key:
            launches += e.count
    kept = spins > 0 and kernels == launches - PROFILE_LEAD_IN
    PROFILE_WINDOWS.append((round(time.perf_counter() - T_START[0], 1),
                            PROFILE_LEAD_IN - spins, kept))
    return rows, kept


def profile_calls(fn, iters):
    """``kernel_rows`` of a window of ``iters`` calls of ``fn`` opened by
    ``lead_in``, taken up to PROFILE_TRIES times until no record of the
    calls was lost."""
    fn(0)
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profiler() as prof:
            lead_in()
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        rows, kept = kernel_rows(prof)
        if kept:
            break
    return rows, kept


def device_ms(fn, iters, names):
    """Device time per call of the CUDA kernels whose names contain one of
    ``names``, from torch.profiler: the card's own time, without the host
    time of the wrapper that launches them.  Each matching kernel launches
    once per call, so a call's time is the sum over them of their mean
    time per recorded launch."""
    rows = [e for e in profile_calls(fn, iters)[0]
            if e.count and any(n in e.key for n in names)]
    if not rows:
        return "not measured"
    return sum(e.self_device_time_total / e.count for e in rows) / 1e3


def ssd_timing_rows(rng, *, B, L, geom, dtype, n_sets):
    """Kernel and plain times of the two passes, and for bf16 of the fused
    scan, at batch ``B``, one chunk of ``L``, geometry ``geom``, with x, B
    and C packed as the mamba layer gives them, cycling over ``n_sets``
    input sets.  ``ms`` is CUDA events around back-to-back wrapper calls
    (it includes the wrapper's host time when that is the longer);
    ``device_ms`` is the kernel's own device time; the chunk pass's
    ``copy_ms`` is what making x, B and C contiguous would add to it (the
    kernels read them in place).  Each row names the variant timed."""
    from repro_torch.kernels.ssd_scan import _state_passing
    from repro_torch.kernels.ssd_scan.kernel import (plan, ssd_apply_cuda,
                                                     ssd_chunk_cuda,
                                                     ssd_scan_fused_cuda)
    from repro_torch.kernels.ssd_scan.ref import (ssd_apply_ref,
                                                  ssd_chunk_ref,
                                                  ssd_scan_fused_ref)
    sets = []
    for _ in range(n_sets):
        ops = ssd_inputs(rng, B=B, S=L, dtype=dtype, **geom)
        x, dt, A, Bm, Cm, s0 = ops
        p1 = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=L)
        s_in, _ = _state_passing(p1[1], p1[2][:, :, -1, :], s0)
        sets.append((ops, p1, Cm.reshape(B, 1, L, geom["G"], geom["N"]),
                     s_in))

    def chunk(fn, i):
        x, dt, A, Bm, Cm, _ = sets[i % n_sets][0]
        fn(x, dt, A, Bm, Cm, chunk=L)

    def apply(fn, i):
        _, p1, cr, s_in = sets[i % n_sets]
        fn(p1[0], cr, p1[2], s_in)

    def fused(fn, i):
        x, dt, A, Bm, Cm, s0 = sets[i % n_sets][0]
        fn(x, dt, A, Bm, Cm, s0, chunk=L)

    def copies(i):
        x, _, _, Bm, Cm, _ = sets[i % n_sets][0]
        for t in (x, Bm, Cm):
            t.contiguous()

    x, _, _, Bm, Cm, _ = sets[0][0]
    var = plan(x, Bm, Cm, chunk=L).variant
    esz = 2 if dtype == torch.bfloat16 else 4
    bounds = ssd_bound(B, 1, L, geom["H"], geom["P"], geom["G"], geom["N"],
                       esz)
    errs = ssd_case_errors(sets[0][0], L)
    runs = [("ssd_chunk", chunk, ssd_chunk_cuda, ssd_chunk_ref, var),
            ("ssd_apply", apply, ssd_apply_cuda, ssd_apply_ref, var)]
    if dtype == torch.bfloat16:
        route, fused_errs = ssd_fused_errors(sets[0][0])
        check(route == "fused", f"the main path's scan took {route}")
        errs.update({f"fused_{k}": e for k, e in fused_errs.items()})
        runs.append(("ssd_scan_fused", fused, ssd_scan_fused_cuda,
                     ssd_scan_fused_ref, "mma"))
    names = {"ssd_chunk": {"mma": ("chunk_mma_kernel",),
                           "simt": ("chunk_simt_kernel",)},
             "ssd_apply": {"mma": ("apply_mma_kernel",),
                           "simt": ("apply_simt_kernel",)},
             "ssd_scan_fused": {"mma": ("fused_mma_kernel",)}}
    rows = []
    for name, run, kern, plain, v in runs:
        t = dict(kernel=name, variant=v, L=L, B=B,
                 dtype=str(dtype).split(".")[-1],
                 geometry=dict(geom),
                 ms=cuda_ms(lambda i: run(kern, i), 20),
                 device_ms=device_ms(lambda i: run(kern, i), 20,
                                     names[name][v]),
                 plain_ms=cuda_ms(lambda i: run(plain, i), 5),
                 bound_ms=bounds[name][0], bound_by=bounds[name][1],
                 library_ms=None)
        if name == "ssd_chunk":
            t["copy_ms"] = cuda_ms(copies, 20)
        keys = {"ssd_chunk": ("y_intra", "states", "cumexp"),
                "ssd_apply": ("y",),
                "ssd_scan_fused": ("fused_y", "fused_final")}[name]
        t["max_rel_err"] = max(errs[k][0] for k in keys)
        t["max_abs_err"] = max(errs[k][1] for k in keys)
        emit("ssd_timing", **t)
        rows.append(t)
    return rows


def phase_ssd_timing(n_sets=4):
    """The SSD kernels timed on the variants the driven paths run: the
    fused scan (mamba2-780m's main path) beside the two tensor-core passes
    at batch 8, L in {16, 64, 256}, bf16, mamba2-780m geometry; then the
    two CUDA-core (simt) passes at the shape the fp32 reference configs'
    chunk step gives them (batch 4, L 16, reduced mamba2 geometry)."""
    rng = np.random.default_rng(4)
    rows = []
    for L in (SPEC_K + 1, 16, 64, 256):
        rows += ssd_timing_rows(rng, B=8, L=L, geom=MAMBA2_GEOM,
                                dtype=torch.bfloat16, n_sets=n_sets)
    simt = []
    for L in (SPEC_K + 1, 16):
        simt += ssd_timing_rows(rng, B=4, L=L, geom=REDUCED_GEOM,
                                dtype=torch.float32, n_sets=n_sets)
    check(all(t["variant"] == "simt" for t in simt),
          f"fp32 passes took {[t['variant'] for t in simt]}")
    return rows + simt


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
    """The matmul kernels against their plain version on the card: the
    tests/test_kernels.py shapes, two ragged shapes, a P = 16 stack, a
    transposed-stride case, and the fast variants' edges (K not a multiple
    of the depth tile, M and N not multiples of the output tile, P = 1 and
    16, the bf16 Cannon round's block), fp32 and bf16 operands,
    ``out_dtype`` fp32 and the default; each case takes the variant
    ``plan`` names (``by_variant`` must move so), and every variant must be
    met.  Then the backward of the op against autograd through the plain
    version (P = 16).  Tolerance: max abs difference over max abs value
    2e-4 with fp32 operands (fp32 FMAs, never TF32, another summation
    order), 3e-2 with bf16 (one rounding of the output to bf16)."""
    from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import (VARIANTS, matmul_cuda,
                                                      plan)
    rng = np.random.default_rng(5)
    cases = [((m, k), (k, n), False) for m, k, n in (
        (256, 256, 256), (512, 256, 384), (128, 512, 128), (128, 128, 128),
        (100, 37, 130), (257, 129, 65), (200, 200, 328))]
    cases += [((16, 64, 48), (16, 48, 80), False),
              ((16, 136, 104), (16, 104, 264), False),
              ((16, 1024, 224), (16, 224, 1216), False),
              ((96, 200), (72, 96), True)]          # a.T @ b.T, as strides
    worst = [0.0, 0.0]
    seen = set()
    for sa, sb, transposed in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = randn(rng, sa, dtype), randn(rng, sb, dtype)
            if transposed:
                a, b = a.t(), b.t()
            variant = plan(a, b).variant
            seen.add(variant)
            for out_dtype in (None, torch.float32):
                want = matmul_ref(a, b, out_dtype)
                n0 = matmul_cuda.by_variant[variant]
                got = matmul_cuda(a, b, out_dtype=out_dtype)
                torch.cuda.synchronize()
                check(matmul_cuda.by_variant[variant] == n0 + 1,
                      f"matmul {sa} {sb}: {variant} not counted")
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"matmul {sa} {sb}: {tuple(got.shape)} {got.dtype}")
                err, abs_err = rel_err(want, got), float(
                    (want.double() - got.double()).abs().max())
                emit("mm_vs_plain", a=list(a.shape), b=list(b.shape),
                     a_strides=list(a.stride()), dtype=dname(dtype),
                     out_dtype=dname(got.dtype), variant=variant,
                     max_rel_err=err, max_abs_err=abs_err, tol=MM_TOL[dtype])
                check(err <= MM_TOL[dtype],
                      f"matmul kernel disagrees: {sa} {sb} {dtype} "
                      f"{variant} rel {err}")
                worst = [max(worst[0], err), max(worst[1], abs_err)]
    check(seen == set(VARIANTS), f"variants met: {sorted(seen)}")
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
    from repro_torch.kernels.cannon_mm.kernel import (VARIANTS, matmul_cuda,
                                                      reset_counts)
    from repro_torch.launch import table1
    rows, meta = table1_report()
    for r in rows:
        emit("table1_model", **r)
    emit("table1_fit", **meta)
    queue = CommandQueue("cuda")
    worst, live = {}, []
    counts = {"launches": 0, "plain": 0}
    by_variant = dict.fromkeys(VARIANTS, 0)
    for spec in table1.DEFAULT_SIZES:
        M, K, N, dtype = table1.parse_size(spec)
        t0 = time.perf_counter()
        A, B, C = table1.operands(M, K, N, dtype, 0, torch.device("cuda"))
        setup_s = time.perf_counter() - t0
        scale = float(C.abs().max())
        reset_counts()                                      # counts to 0 ...
        matmul_ref.launches = 0
        errs = strategy_errors(A, B, C, scale)
        counts["launches"] += matmul_cuda.launches          # ... read
        counts["plain"] += matmul_ref.launches
        ran = {k: n for k, n in matmul_cuda.by_variant.items() if n}
        for k, n in ran.items():
            by_variant[k] += n
        fast = "wgmma_tma" if dtype == torch.bfloat16 else "f32_vec"
        check(ran == {fast: matmul_cuda.launches},
              f"cannon at {spec}: launches by variant {ran}, expected all "
              f"{matmul_cuda.launches} on {fast}")
        tol = MM_TOL[dtype]
        emit("cannon", size=spec, dtype=dname(dtype), operands_s=setup_s,
             by_variant=ran, max_rel_err=errs, tol=tol)
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
    return counts["launches"], by_variant, worst, live


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
    fp32, at the n = 8192 Cannon round (16 PEs x 2048^3, fp32), the main
    path's largest, and at the bf16 Cannon round of qwen2-0.5b's MLP
    up-projection (16 PEs x (1024 x 224) @ (224 x 1216), bf16 in, fp32 out,
    as core/cannon.py::_mm asks).  ``ms`` is CUDA events around
    back-to-back wrapper calls, ``device_ms`` the planned variant's kernel
    time from torch.profiler; ``library_ms`` is one torch.matmul (TF32
    off), timed and never used; for the bf16 round it is one torch.bmm in
    bf16, whose output is bf16 (the kernel's is fp32)."""
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import (VARIANTS, matmul_cuda,
                                                      plan)
    rng = np.random.default_rng(6)
    rows = []
    for label, P, M, K, N, dtype, out_dtype in (
            ("4096^3 bf16", 1, 4096, 4096, 4096, torch.bfloat16, None),
            ("4096^3 fp32", 1, 4096, 4096, 4096, torch.float32, None),
            ("cannon round n=8192: 16 x 2048^3 fp32", 16, 2048, 2048, 2048,
             torch.float32, None),
            ("cannon round 4096x896x4864 bf16: 16 x (1024x224)@(224x1216) "
             "-> fp32", 16, 1024, 224, 1216, torch.bfloat16, torch.float32)):
        a, b = randn(rng, (P, M, K), dtype), randn(rng, (P, K, N), dtype)
        if P == 1:
            a, b = a[0], b[0]
        variant = plan(a, b).variant
        def kern(i, a=a, b=b, out_dtype=out_dtype):
            return matmul_cuda(a, b, out_dtype=out_dtype)

        want, got = matmul_ref(a, b, out_dtype), kern(0)
        torch.cuda.synchronize()
        t = dict(shape=label, P=P, M=M, K=K, N=N, dtype=dname(dtype),
                 out_dtype=dname(got.dtype), variant=variant,
                 ms=cuda_ms(kern, 10),
                 device_ms=device_ms(kern, 5, (VARIANTS[variant].kernel,)),
                 plain_ms=cuda_ms(lambda i: matmul_ref(a, b, out_dtype), 5),
                 library_ms=cuda_ms(lambda i: torch.matmul(a, b), 10),
                 max_rel_err=rel_err(want, got),
                 max_abs_err=float((want.double() - got.double())
                                   .abs().max()))
        if P > 1 and dtype == torch.bfloat16:
            t["library"] = "torch.bmm, bf16 out"
        t["bound_ms"], t["bound_by"] = mm_bound(P, M, K, N, dtype,
                                                got.dtype)
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
                                     3, ("flash_bf16_kernel",)),
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


# ---------------------------------------------------------------------------
# The grouped GEMM (the MoE experts).
# ---------------------------------------------------------------------------

QWEN3_MOE_EXPERTS = dict(E=128, k=8)
# (K, N) of the two expert products: w1 (D, 2F) gate | up, w2 (F, D)
GMM_PRODUCTS = {"w1": (4096, 2 * 1536), "w2": (1536, 4096)}
GMM_M = {"decode": 64, "verify": 320, "len16": 1024, "len64": 4096,
         "len256": 16384}                # M = T*k at batch 8, top-8
# the kernel and its plain version both sum in fp32 and round once: where
# the two sums straddle a rounding boundary the bf16 outputs differ by one
# bf16 ulp (at most 2^-7 of the value, so of the largest value); fp32 ones
# by the summation order over K
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def routed_offsets(rng, T, E, k):
    """Offsets (E + 1,) of T tokens, each routed to k distinct experts
    drawn uniformly (random router weights route about so)."""
    e = np.argsort(rng.random((T, E)), axis=1)[:, :k]
    counts = np.bincount(e.ravel(), minlength=E)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def gmm_weights(E, K, N, dtype, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn((E, K, N), generator=gen, device="cuda",
                       dtype=dtype) * K ** -0.5


def gmm_fns(swiglu):
    """(wrapper, plain version) of the grouped GEMM, or of its fused first
    product with the silu x up epilogue."""
    from repro_torch.kernels.grouped_mm import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda)
    return ((grouped_mm_swiglu_cuda, grouped_mm_swiglu_ref) if swiglu
            else (grouped_mm_cuda, grouped_mm_ref))


def gmm_variants(dtype, swiglu, N):
    """The variants to hold against the plain version: every bf16 variant
    (the epilogue needs N a multiple of 16), simt for fp32."""
    if dtype == torch.float32:
        return ("simt",)
    return ("mma", "wgmma_tma") if not swiglu or N % 16 == 0 else ()


def gmm_errors(x, w, offsets, swiglu=False, variant=None):
    """(rel, abs) error of the kernel (the named variant, or the planned
    one) against the plain version on the card; the rows of no expert
    must be exactly zero."""
    kern, ref = gmm_fns(swiglu)
    off = torch.from_numpy(offsets).cuda()
    want = ref(x, w, off)
    got = kern(x, w, off, variant=variant)
    torch.cuda.synchronize()
    label = f"{kern.__name__} ({variant})"
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    lo, hi = int(offsets[0]), int(offsets[-1])
    check(not got[:lo].any() and not got[hi:].any(),
          f"{label}: a row of no expert is not zero")
    return rel_err(want, got), float((want.double() - got.double())
                                     .abs().max())


# edge cases of the grouped GEMM and its backward: (label, M, K, N, E,
# group sizes, rows before offsets[0])
GMM_EDGES = [("empty experts", 77, 64, 64, 16,
              [0, 9, 0, 0, 30, 0, 0, 1, 0, 0, 0, 17, 0, 0, 20, 0], 0),
             ("one expert, several M tiles", 300, 64, 144, 16,
              [0] * 5 + [300] + [0] * 10, 0),
             ("ragged K and N, rows past offsets[E]", 100, 40, 80, 6,
              [13, 0, 25, 2, 0, 30], 0),
             ("rows before offsets[0] and past offsets[E]", 90, 32, 64, 4,
              [20, 0, 31, 9], 11),
             ("no expert has a row", 33, 32, 64, 8, [0] * 8, 5),
             ("one expert of 600 rows, ragged N tiles", 720, 96, 208, 5,
              [40, 600, 0, 7, 13], 45)]


def edge_offsets(sizes, head):
    return (head + np.concatenate([[0], np.cumsum(sizes)])).astype(np.int32)


def phase_gmm_vs_plain():
    """Every variant of the grouped GEMM and of its fused first product
    (``grouped_mm_swiglu``) against their plain versions: bf16 ``mma`` and
    ``wgmma_tma`` (forced, whatever plan would pick) at qwen3-moe's two
    products and every GMM_M stage, fp32 ``simt`` at decode and verify,
    and the edge cases.  Returns {(function, variant): (rel, abs)}, worst
    of each."""
    rng = np.random.default_rng(8)
    E, k = QWEN3_MOE_EXPERTS["E"], QWEN3_MOE_EXPERTS["k"]
    worst = {}
    cases = []

    def run(label, x, w, offsets, dtype):
        M, K = x.shape
        E_, _, N = w.shape
        for swiglu in (False, True):
            for v in gmm_variants(dtype, swiglu, N):
                cases.append((label, M, K, N, E_, dtype, swiglu, v,
                              *gmm_errors(x, w, offsets, swiglu, v)))

    for dtype in (torch.bfloat16, torch.float32):
        for prod, (K, N) in GMM_PRODUCTS.items():
            w = gmm_weights(E, K, N, dtype, seed=len(cases))
            for stage, M in GMM_M.items():
                if dtype == torch.float32 and M > 320:
                    continue
                offsets = routed_offsets(rng, M // k, E, k)
                x = torch.from_numpy(rng.standard_normal(
                    (M, K), "float32")).to("cuda", dtype)
                run(f"{prod} {stage}", x, w, offsets, dtype)
            del w
    for label, M, K, N, E_, sizes, head in GMM_EDGES:
        offsets = edge_offsets(sizes, head)
        for dtype in (torch.bfloat16, torch.float32):
            w = gmm_weights(E_, K, N, dtype, seed=M)
            x = torch.from_numpy(rng.standard_normal(
                (M, K), "float32")).to("cuda", dtype)
            run(label, x, w, offsets, dtype)
    # fp32 at a K and an N that no tile divides (the simt variant only)
    offsets = np.array([0, 7, 7, 31, 50], np.int32)
    w = gmm_weights(4, 37, 70, torch.float32, seed=3)
    x = torch.from_numpy(rng.standard_normal((53, 37), "float32")).cuda()
    run("fp32 K 37, N 70", x, w, offsets, torch.float32)
    for label, M, K, N, E_, dtype, swiglu, v, err, abs_err in cases:
        fn = "grouped_mm_swiglu" if swiglu else "grouped_mm"
        emit("gmm_vs_plain", case=label, fn=fn, variant=v, M=M, K=K, N=N,
             E=E_, dtype=dname(dtype), max_rel_err=err, max_abs_err=abs_err,
             tol=GMM_TOL[dtype])
        check(err <= GMM_TOL[dtype],
              f"{fn} ({v}) disagrees: {label} {dname(dtype)} rel {err}")
        w0 = worst.get((fn, v), (0.0, 0.0))
        worst[(fn, v)] = (max(w0[0], err), max(w0[1], abs_err))
    torch.cuda.empty_cache()
    return worst


def gmm_bound(offsets, K, N, dtype, swiglu=False):
    """Least time of one call on these offsets: the active experts'
    weights, the routed rows of x and the output (N columns, N / 2 with
    the epilogue) each moved once at 3.35 TB/s, against 2 * rows * K * N
    operations at the type's peak (``kernels/grouped_mm/cost.py`` counts
    both)."""
    from repro_torch.kernels.grouped_mm import cost
    esz = torch.tensor([], dtype=dtype).element_size()
    rows, active, E = cost.from_offsets(offsets)
    elems = cost.elements("swiglu" if swiglu else "forward", rows, K, N, E,
                          active)
    tb = elems * esz / HBM_BYTES_S * 1e3
    to = cost.operations(rows, K, N) / PEAK_FLOPS[dname(dtype)] * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", active


def library_gmm(x, w, offsets):
    """One ``torch._grouped_mm`` call on the same inputs (end offsets of
    each group), timed as the yardstick and never used by the port; w as
    it is or column-major, whichever the card's PyTorch takes.  Returns
    (callable or None, what it was or why there is none)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this PyTorch has no torch._grouped_mm"
    offs = offsets[1:].contiguous()
    why = ""
    for label, b in (("w row-major", w),
                     ("w column-major", w.transpose(-2, -1).contiguous()
                      .transpose(-2, -1))):
        try:
            fn(x, b, offs=offs)
            torch.cuda.synchronize()
            return (lambda b=b: fn(x, b, offs=offs)), \
                f"torch._grouped_mm, {label}"
        except Exception as e:          # noqa: BLE001  a yardstick only
            why = f"torch._grouped_mm refused: {str(e)[:160]}"
    return None, why


def swiglu_glue(h):
    """The torch lines the fused epilogue replaces (models/moe.py before
    it): silu of the gate half in fp32, rounded, times the up half."""
    F = h.shape[1] // 2
    return torch.nn.functional.silu(h[:, :F].float()).to(h.dtype) * h[:, F:]


def busy_ms(fn, iters):
    """Device time per call of every CUDA kernel ``fn`` starts, from
    torch.profiler (their summed own times over ``iters`` calls); "not
    measured" where the trace lost a record (``profile_calls``)."""
    kern, kept = profile_calls(fn, iters)
    if not kern or not kept:
        return "not measured"
    return sum(e.self_device_time_total for e in kern) / 1e3 / iters


def gmm_timing_row(shape, x, w, offsets, swiglu):
    """Every variant of one call timed (events ``ms``, the kernel's own
    ``device_ms``), the planned one's numbers at the top; the plain
    version, the library call and the bound.  With the epilogue also the
    unfused path it replaces: the planned grouped_mm and the torch glue,
    and the library call and the glue."""
    from repro_torch.kernels.grouped_mm.kernel import VARIANTS, plan
    kern, ref = gmm_fns(swiglu)
    dtype = x.dtype
    (M, K), (E, _, N) = x.shape, w.shape
    off = torch.from_numpy(offsets).cuda()
    want = ref(x, w, off)
    variant = plan(x, w, swiglu)
    per = {}
    for v in gmm_variants(dtype, swiglu, N):
        def call(i, v=v):
            return kern(x, w, off, variant=v)
        got = call(0)
        per[v] = dict(ms=cuda_ms(call, 10),
                      device_ms=device_ms(call, 5, (VARIANTS[v],)),
                      max_rel_err=rel_err(want, got),
                      max_abs_err=float((want.double() - got.double())
                                        .abs().max()))
        del got
    t = dict(shape=shape, fn=kern.__name__[:-len("_cuda")], M=M, K=K, N=N,
             E=E, dtype=dname(dtype), variant=variant, **{
                 k: per[variant][k] for k in ("ms", "device_ms")},
             max_rel_err=max(p["max_rel_err"] for p in per.values()),
             max_abs_err=max(p["max_abs_err"] for p in per.values()),
             by_variant=per, plain_ms=cuda_ms(lambda i: ref(x, w, off), 3))
    lib, t["library"] = library_gmm(x, w, off) \
        if dtype == torch.bfloat16 else (None, "bf16 only")
    if swiglu:
        # one PyTorch call cannot compute the fused function: the library
        # product and the glue stand beside it as "library_plus_glue"
        gk, _ = gmm_fns(False)

        def unfused(i):
            return swiglu_glue(gk(x, w, off))
        t.update(library_ms=None, unfused_ms=cuda_ms(unfused, 10),
                 unfused_busy_ms=busy_ms(unfused, 5),
                 library_plus_glue_ms=cuda_ms(
                     lambda i: swiglu_glue(lib()), 10) if lib else None)
    else:
        t["library_ms"] = cuda_ms(lambda i: lib(), 10) if lib else None
    if lib:
        lo, hi = int(offsets[0]), int(offsets[-1])
        got = kern(x, w, off)
        ref_lib = swiglu_glue(lib()) if swiglu else lib()
        t["library_vs_kernel_rel_err"] = rel_err(got[lo:hi], ref_lib[lo:hi])
        del got, ref_lib
    t["bound_ms"], t["bound_by"], t["active_experts"] = \
        gmm_bound(offsets, K, N, dtype, swiglu)
    emit("gmm_timing", **t)
    check(t["max_rel_err"] <= GMM_TOL[dtype], f"grouped_mm timing case {t}")
    return t


def phase_gmm_timing():
    """Kernel, plain and library times of the grouped GEMM at qwen3-moe's
    two expert products, rows routed top-8 of 128 as the engine routes
    random weights, at every GMM_M stage in bf16 (batch-8 decode, M 64,
    about 52 experts active; verify at k = 4, M 320; the len16, len64 and
    len256 chunks, every expert active), each bf16 variant at each, and w1
    also fused with the silu x up epilogue; decode also in fp32 (simt).
    ``ms`` is CUDA events around back-to-back wrapper calls, ``device_ms``
    the kernel's own time from torch.profiler."""
    rng = np.random.default_rng(9)
    E, k = QWEN3_MOE_EXPERTS["E"], QWEN3_MOE_EXPERTS["k"]
    rows = []
    for dtype, stages in ((torch.bfloat16, tuple(GMM_M)),
                          (torch.float32, ("decode",))):
        for prod, (K, N) in GMM_PRODUCTS.items():
            w = gmm_weights(E, K, N, dtype, seed=11)
            for stage in stages:
                M = GMM_M[stage]
                offsets = routed_offsets(rng, M // k, E, k)
                x = torch.from_numpy(rng.standard_normal(
                    (M, K), "float32")).to("cuda", dtype)
                for swiglu in (False, True) if prod == "w1" else (False,):
                    rows.append(gmm_timing_row(f"{prod} {stage}", x, w,
                                               offsets, swiglu))
                del x
            del w
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The grouped GEMM's backward and training.
# ---------------------------------------------------------------------------

# the backward replaces the transpose JAX's autodiff makes of the two
# ragged_dot calls (no Pallas kernel)
GMM_GRAD_REPLACES = "src/repro/models/moe.py:116,120"
# rows of the backward products: batch-8 decode (64) and a training step
# of batch 8 x len 1024 at top-8 (65536), uniform and skewed
GMM_GRAD_M = {"decode": 64, "train": 65536}
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 8, 6
# the peak learning rate (warmup 10 steps, as the launcher): a pretraining
# rate for models of these sizes.  At 3e-4 the 8-bit moments of the
# reference's AdamW (block-quantized linearly, as the port reproduces
# them) threw qwen3-moe's loss back above its start by the sixth step:
# an expert that loses its tokens gets a zero gradient, its second moment
# quantized to zero, and an update of m / eps.  The probe runs show it.
TRAIN_LR = 1e-4
# (arch, layers or None for the full depth, moment bits, peak lr, gated):
# gated runs must lower the loss; the probes, at 3x the rate, report the
# reference's 8-bit moments beside fp32 ones (1 layer: what fits)
TRAIN_RUNS = (("qwen2-0.5b", None, 32, TRAIN_LR, True),
              ("mamba2-780m", None, 32, TRAIN_LR, True),
              ("qwen3-moe-235b-a22b", 2, 8, TRAIN_LR, True),
              ("qwen3-moe-235b-a22b", 2, 8, 3 * TRAIN_LR, False),
              ("qwen3-moe-235b-a22b", 1, 32, 3 * TRAIN_LR, False))


def skewed_offsets(rng, T, E, k, n_empty=16, tail=0):
    """Offsets of T tokens routed top-k over experts of Zipf-like
    popularity (weight 1 / rank^1.2), ``n_empty`` experts never chosen,
    and ``tail`` rows past offsets[E]."""
    w = 1.0 / np.arange(1, E + 1) ** 1.2
    w[rng.choice(E, n_empty, replace=False)] = 0.0
    picks = np.stack([rng.choice(E, k, replace=False, p=w / w.sum())
                      for _ in range(T)])
    counts = np.bincount(picks.ravel(), minlength=E)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return off, off[-1] + tail


def grad_fns():
    """name -> (kernel wrapper, plain version) of the backward products."""
    from repro_torch.kernels.grouped_mm import (grouped_mm_dgrad_ref,
                                                grouped_mm_wgrad_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_dgrad_cuda, grouped_mm_wgrad_cuda)
    return {"grouped_mm_dgrad": (grouped_mm_dgrad_cuda,
                                 grouped_mm_dgrad_ref),
            "grouped_mm_wgrad": (grouped_mm_wgrad_cuda,
                                 grouped_mm_wgrad_ref)}


def grad_cases(rng, edges=False):
    """(label, x, w, dy, offsets) at qwen3-moe's two products: decode and
    training rows routed uniformly top-8 in bf16, training rows on skewed
    routing with 16 empty experts and 64 rows past offsets[E] in bf16, and
    decode in fp32; with ``edges`` then GMM_EDGES in bf16 and fp32."""
    E, k = QWEN3_MOE_EXPERTS["E"], QWEN3_MOE_EXPERTS["k"]
    for dtype, stages in ((torch.bfloat16, ("decode", "train", "skewed")),
                          (torch.float32, ("decode", "skewed"))):
        for prod, (K, N) in GMM_PRODUCTS.items():
            w = gmm_weights(E, K, N, dtype, seed=21)
            for stage in stages:
                if stage == "skewed":
                    T = (GMM_GRAD_M["train"] if dtype == torch.bfloat16
                         else 4096) // k
                    offsets, M = skewed_offsets(rng, T, E, k, tail=64)
                    M = int(M)
                else:
                    M = GMM_GRAD_M[stage]
                    offsets = routed_offsets(rng, M // k, E, k)
                # drawn on the card: 65536-row operands from a host
                # generator would take seconds each
                gen = torch.Generator("cuda").manual_seed(M + K)
                x = torch.randn((M, K), generator=gen, device="cuda"
                                ).to(dtype)
                dy = torch.randn((M, N), generator=gen, device="cuda"
                                 ).to(dtype)
                yield f"{prod} {stage}", x, w, dy, offsets
                del x, dy
            del w
            torch.cuda.empty_cache()
    if not edges:
        return
    for label, M, K, N, E_, sizes, head in GMM_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator("cuda").manual_seed(M)
            yield (label, torch.randn((M, K), generator=gen,
                                      device="cuda").to(dtype),
                   gmm_weights(E_, K, N, dtype, seed=M),
                   torch.randn((M, N), generator=gen,
                               device="cuda").to(dtype),
                   edge_offsets(sizes, head))


def swiglu_backward(x, w, off, dy, plain):
    """The backward of ``grouped_mm_swiglu`` (dx, dw) for cotangent dy (M,
    N / 2): through the op's autograd function on the card, or its plain
    version (the product recomputed by the plain grouped GEMM, the same
    glue, the plain dgrad and wgrad)."""
    from repro_torch.kernels.grouped_mm import (grouped_mm_dgrad_ref,
                                                grouped_mm_ref,
                                                grouped_mm_swiglu,
                                                grouped_mm_wgrad_ref,
                                                swiglu_grad)
    if plain:
        dh = swiglu_grad(grouped_mm_ref(x, w, off), dy)
        return grouped_mm_dgrad_ref(dh, w, off), \
            grouped_mm_wgrad_ref(x, dh, off)
    xs = x.detach().requires_grad_(True)
    ws = w.detach().requires_grad_(True)
    return torch.autograd.grad(grouped_mm_swiglu(xs, ws, off), (xs, ws), dy)


def sliced_err(want, got):
    """(rel, abs) error of ``got`` against ``want`` over their largest
    element, in fp64 one leading slice at a time (a full-width fp32 dw
    would need 12.8 GB a copy in fp64)."""
    diff = scale = 0.0
    for a, b in zip(want, got):
        a, b = a.double(), b.double()
        diff = max(diff, float((a - b).abs().max()))
        scale = max(scale, float(a.abs().max()))
    return diff / max(scale, 1e-30), diff


def hold_grad(worst, name, label, x, w, offsets, want, got):
    """One backward output against its plain version: finite; rows of no
    expert (dx) or experts with no rows (dw) exact zeros; within GMM_TOL of
    its largest element.  Keeps the worst (rel, abs) per name."""
    lo, hi = int(offsets[0]), int(offsets[-1])
    empty = torch.from_numpy(np.diff(offsets) == 0).cuda()
    tag = f"{name} {label}"
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
    if got.shape[0] == x.shape[0]:      # dx: rows of no expert
        check(not got[:lo].any() and not got[hi:].any(),
              f"{tag}: a row of no expert not zero")
        output = "dx"
    else:                               # dw: experts with no rows
        check(not got[empty].any(), f"{tag}: an empty expert's dw not zero")
        output = "dw"
    err, abs_err = sliced_err(want, got)
    emit("gmm_grad_vs_plain", case=label, fn=name, output=output, M=x.shape[0], K=w.shape[1], N=w.shape[2],
         E=w.shape[0], rows=hi - lo, empty_experts=int(empty.sum()),
         dtype=dname(x.dtype), max_rel_err=err, max_abs_err=abs_err,
         tol=GMM_TOL[x.dtype])
    check(err <= GMM_TOL[x.dtype],
          f"{tag} disagrees: {dname(x.dtype)} rel {err}")
    w0 = worst.get(name, (0.0, 0.0))
    worst[name] = (max(w0[0], err), max(w0[1], abs_err))


def phase_gmm_grad_vs_plain():
    """dgrad and wgrad (bf16 wgmma_tma, fp32 simt) and the swiglu backward
    against their plain versions at qwen3-moe's shapes and the edge cases
    (``grad_cases``), each within GMM_TOL of its largest element (both sum
    products in fp32 and round once); rows of no expert and experts with
    no rows exactly zero; a second call on the same inputs the same bits.
    Returns {name: (rel, abs)}, worst of each."""
    rng = np.random.default_rng(31)
    worst = {}
    fns = grad_fns()
    for label, x, w, dy, offsets in grad_cases(rng, edges=True):
        off = torch.from_numpy(offsets).cuda()
        for kind in ("dgrad", "wgrad"):
            name = f"grouped_mm_{kind}"
            kern, ref = fns[name]
            args = (dy, w, off) if kind == "dgrad" else (x, dy, off)
            want = ref(*args)
            got = kern(*args)
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} {label}: two calls "
                                           f"differ")
            del again
            hold_grad(worst, name, label, x, w, offsets, want, got)
            del got, want
        if w.shape[2] % 16 == 0:
            hy = dy[:, :w.shape[2] // 2].contiguous()
            got = swiglu_backward(x, w, off, hy, plain=False)
            want = swiglu_backward(x, w, off, hy, plain=True)
            torch.cuda.synchronize()
            for a, b in zip(want, got):
                hold_grad(worst, "grouped_mm_swiglu backward", label, x, w,
                          offsets, a, b)
            del got, want
        torch.cuda.empty_cache()
    return worst


def grad_bound(kind, offsets, K, N, dtype):
    """Least time of one backward product on these offsets: dgrad reads
    the active experts' weights, dy's routed rows and writes dx; wgrad
    reads x's and dy's routed rows and writes every expert's dw (E x K x
    N, zeros included); 2 * rows * K * N operations each
    (``kernels/grouped_mm/cost.py``)."""
    from repro_torch.kernels.grouped_mm import cost
    esz = torch.tensor([], dtype=dtype).element_size()
    rows, active, E = cost.from_offsets(offsets)
    tb = cost.elements(kind, rows, K, N, E, active) * esz / HBM_BYTES_S * 1e3
    to = cost.operations(rows, K, N) / PEAK_FLOPS[dname(dtype)] * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def library_grad(kind, x, w, dy, offsets):
    """One PyTorch call computing the same product, timed as the
    yardstick and never used by the port: ``torch._grouped_mm`` (dgrad:
    dy by w transposed; wgrad: x^T by dy with the groups along the
    contracted rows, which it takes only when every group's rows are a
    multiple of 8), else the per-expert ``torch.matmul`` loop.  Returns
    (callable, what it is)."""
    fn = getattr(torch, "_grouped_mm", None)
    ends = offsets[1:].contiguous()
    tries = []
    if fn is not None and x.dtype == torch.bfloat16:
        if kind == "dgrad":
            tries = [("torch._grouped_mm, w^T as a view",
                      lambda: fn(dy, w.transpose(-2, -1), offs=ends))]
        elif not (np.diff(offsets.tolist()) % 8).any():
            # its groups along the contracted rows must each be a multiple
            # of 16 bytes (a device-side assert otherwise)
            xt = x.t().contiguous()
            tries = [("torch._grouped_mm, x^T contiguous",
                      lambda: fn(xt, dy, offs=ends))]
    for label, call in tries:
        try:
            call()
            torch.cuda.synchronize()
            return call, label
        except Exception:               # noqa: BLE001  a yardstick only
            pass
    off = offsets.tolist()
    if kind == "dgrad":
        def loop():
            out = torch.zeros((dy.shape[0], w.shape[1]), dtype=dy.dtype,
                              device=dy.device)
            for e in range(w.shape[0]):
                if off[e + 1] > off[e]:
                    out[off[e]:off[e + 1]] = dy[off[e]:off[e + 1]] @ w[e].T
            return out
    else:
        def loop():
            out = torch.zeros(w.shape, dtype=x.dtype, device=x.device)
            for e in range(w.shape[0]):
                if off[e + 1] > off[e]:
                    out[e] = x[off[e]:off[e + 1]].T @ dy[off[e]:off[e + 1]]
            return out
    return loop, "per-expert torch.matmul loop"


def phase_gmm_grad_timing():
    """dgrad, wgrad and the swiglu backward at ``grad_cases``' shapes:
    events ms and the kernel's device ms (``device_ms`` by name), beside
    the plain version, one library call (``library_grad``) and the
    bound."""
    from repro_torch.kernels.grouped_mm.kernel import (GRAD_VARIANTS,
                                                       grad_route)
    rng = np.random.default_rng(32)
    fns = grad_fns()
    rows = []
    for label, x, w, dy, offsets in grad_cases(rng):
        off = torch.from_numpy(offsets).cuda()
        dtype = x.dtype
        (M, _), (E, K, N) = x.shape, w.shape
        variant = grad_route(dtype, K, N)
        for kind in ("dgrad", "wgrad"):
            name = f"grouped_mm_{kind}"
            kern, ref = fns[name]
            args = (dy, w, off) if kind == "dgrad" else (x, dy, off)

            def call(i):
                return kern(*args)
            lib, lib_what = library_grad(kind, x, w, dy, off)
            t = dict(shape=label, fn=name, variant=variant, M=M, K=K, N=N,
                     E=E, dtype=dname(dtype),
                     rows=int(offsets[-1] - offsets[0]),
                     active_experts=int((np.diff(offsets) > 0).sum()),
                     ms=cuda_ms(call, 5),
                     device_ms=device_ms(call, 5,
                                         (GRAD_VARIANTS[kind][variant],)),
                     plain_ms=cuda_ms(lambda i: ref(*args), 2),
                     library_ms=cuda_ms(lambda i: lib(), 3),
                     library=lib_what)
            t["bound_ms"], t["bound_by"] = grad_bound(kind, offsets, K, N,
                                                      dtype)
            emit("gmm_grad_timing", **t)
            rows.append(t)
        hy = dy[:, :N // 2].contiguous()
        t = dict(shape=label, fn="grouped_mm_swiglu backward", M=M,
                 K=K, N=N, dtype=dname(dtype),
                 ms=cuda_ms(lambda i: swiglu_backward(x, w, off, hy, False),
                            3),
                 busy_ms=busy_ms(lambda i: swiglu_backward(x, w, off, hy,
                                                           False), 2),
                 plain_ms=cuda_ms(lambda i: swiglu_backward(x, w, off, hy,
                                                            True), 2))
        emit("gmm_grad_timing", **t)
        rows.append(t)
    torch.cuda.empty_cache()
    return rows


def train_counters():
    """name -> (kernel wrapper, plain version) of every grouped-GEMM
    kernel the MoE training step launches."""
    c = {k: v for k, v in kernel_counters().items()
         if k.startswith("grouped_mm")}
    c.update(grad_fns())
    return c


def train_model(arch, layers, bits, lr, gated, smi, seq=TRAIN_SEQ,
                batch_size=TRAIN_BATCH):
    """One run of ``arch`` at full width (``layers`` cuts its depth)
    through the functions launch/train.py calls (``train_config``,
    ``check_fit``, ``setup``, ``data_config``, ``device_batch``):
    TRAIN_STEPS AdamW steps on one batch of ``batch_size`` x ``seq``
    positions at the config's vocab (whisper's batch adds its encoder's
    stub frames, pixtral's puts its patches in front of the text), the
    layer groups recomputed in the backward.  Gates: every parameter on
    the card; for an MoE model the grouped GEMM's kernels launched as the
    layers and steps imply (forward, its recompute and the swiglu
    backward's recomputed product; dgrad and wgrad for both products), the
    plain versions never.  Gated runs also: every loss and grad norm
    finite, the last loss (after 5 updates) below the first.  Steps
    TRAIN_PROFILED of a gated MoE run run under torch.profiler
    (``phase_train_profile``); the steady wall is the median of the other
    steps after the first.  Returns (row, the profile's row or None)."""
    from repro_torch.kernels.grouped_mm.kernel import reset_counts
    from repro_torch.launch import train as launch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = launch.train_config(arch, full=True, layers=layers)
    need = launch.check_fit(cfg, DEV, bits)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=10, decay_steps=100,
                          state_bits=bits)
    run = f"{arch} train{'' if gated else ' probe'} ({cfg.n_layers} " \
          f"layers, {bits}-bit moments, lr {lr:g})"
    t0 = time.perf_counter()
    params, opt, step_fn = launch.setup(cfg, device=DEV, opt_cfg=opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(t.device.type == DEV for t in leaves(params)),
          f"{arch}: a parameter is not on the card")
    dc = launch.data_config(cfg, seq, batch_size, full=True)
    batch = launch.device_batch(dc, 0, DEV)
    torch.cuda.reset_peak_memory_stats()
    counters = train_counters()
    zero_counts()
    reset_counts()
    for kern, plain in counters.values():
        plain.launches = 0
    n_moe = sum(f == "moe" for _, f in cfg.pattern()) * cfg.n_groups()
    profiled = TRAIN_PROFILED if gated and n_moe else ()
    prof = profiler() if profiled else None
    losses, norms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        if profiled and i == profiled[0]:
            prof.start()
            lead_in()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if profiled and i == profiled[-1]:
            prof.stop()
    got = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: p.launches for k, (_, p) in counters.items()}
    by_variant = {k: dict(kern.by_variant)
                  for k, (kern, _) in counters.items()}
    tokens = batch_size * seq
    # the steady wall: the median of the steps after the first that ran
    # without the profiler
    rest = [t for i, t in enumerate(walls) if i and i not in profiled]
    steady = sorted(rest)[len(rest) // 2]
    row = dict(run=run, gated=gated, arch=arch, layers=cfg.n_layers,
               d_model=cfg.d_model, vocab=cfg.vocab_size, state_bits=bits,
               lr=lr, batch=batch_size, seq=seq, tokens_per_step=tokens,
               batch_shapes={k: list(v.shape) for k, v in batch.items()},
               state_gb=round(need["total"] / 1e9, 3),
               init_s=round(init_s, 3), step_wall_ms=walls,
               profiled_steps=list(profiled), steady_step_ms=steady,
               tokens_per_s=tokens / steady * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, grad_norms=norms, launches=got,
               by_variant=by_variant, plain_launches=plain, nvidia_smi=smi)
    emit("train", **row)
    if gated:
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"{run}: a non-finite loss or grad norm {losses} {norms}")
        check(losses[-1] < losses[0],
              f"{run}: the loss after {TRAIN_STEPS - 1} updates on one "
              f"batch is not below the first: {losses}")
    check(not any(plain.values()), f"{run}: a plain version ran {plain}")
    if n_moe:
        per = n_moe * TRAIN_STEPS
        want = {"grouped_mm_swiglu": 2 * per, "grouped_mm": 3 * per,
                "grouped_mm_dgrad": 2 * per, "grouped_mm_wgrad": 2 * per}
        check(got == want, f"{run}: grouped GEMM launches {got}, the "
                           f"layers and steps imply {want}")
        for k in ("grouped_mm_dgrad", "grouped_mm_wgrad"):
            check(by_variant[k]["wgmma_tma"] == got[k],
                  f"{run}: {k} launched off wgmma_tma: {by_variant[k]}")
    profile_row = None
    if profiled:
        profile_row = phase_train_profile(
            run, prof, [walls[i] for i in profiled],
            [losses[i] for i in profiled], n_moe)
    del params, opt, step_fn, batch, m, prof
    gc.collect()
    torch.cuda.empty_cache()
    return row, profile_row


def phase_train(smi):
    """Each TRAIN_RUNS model (``train_model``).  Returns ({kernel:
    launches}, {kernel: {run: launches}}, rows, the profile's row)."""
    counts, by_run, rows, profile_row = {}, {}, [], None
    for arch, layers, bits, lr, gated in TRAIN_RUNS:
        row, prof_row = train_model(arch, layers, bits, lr, gated, smi)
        rows.append(row)
        profile_row = prof_row or profile_row
        for k, n in row["launches"].items():
            counts[k] = counts.get(k, 0) + n
            if n:
                by_run.setdefault(k, {})[row["run"]] = n
    check(profile_row is not None, "no gated MoE run was profiled")
    return counts, by_run, rows, profile_row


# the gated MoE run's steps (0-based) run under the profiler: the first
# steady ones, before the loss has gone far from its start
TRAIN_PROFILED = (1, 2)
# the grouped GEMM's kernels in a train step's profile, by name
TRAIN_SHARES = {"grouped_mm forward": ("::gmm_wgmma_tma_kernel",
                                       "::gmm_mma_kernel",
                                       "::gmm_simt_kernel"),
                "grouped_mm dgrad": ("::gmm_dgrad_",),
                "grouped_mm wgrad": ("::gmm_wgrad_",)}


def phase_train_profile(run, prof, walls, losses, n_moe):
    """Where a steady train step's time goes, from ``prof``, a profile of
    len(walls) steps of a run, each synchronised, opened by ``lead_in``.
    Device busy (the kernels' summed own times a step), its idle share
    (the rest of the host wall) and the grouped GEMM's forward, dgrad and
    wgrad shares of busy are reported only where the trace kept every
    record: ``kernel_rows`` finds none lost, and the grouped GEMM's
    recorded launches are those ``n_moe`` MoE layers make (forward 5,
    dgrad 2, wgrad 2 a layer a step); otherwise "not measured".  Returns
    the row."""
    n = len(walls)
    rows, kept = kernel_rows(prof)
    kern = {e.key: (e.self_device_time_total / 1e3 / n, e.count)
            for e in rows if e.count}
    check(bool(kern), f"{run}: the profiled train step shows no kernel")
    expected = {"grouped_mm forward": 5 * n_moe * n,
                "grouped_mm dgrad": 2 * n_moe * n,
                "grouped_mm wgrad": 2 * n_moe * n}
    shares = {}
    for label, names in TRAIN_SHARES.items():
        mine = [v for k, v in kern.items() if any(x in k for x in names)]
        recorded = sum(c for _, c in mine)
        kept = kept and recorded == expected[label]
        shares[label] = dict(ms=sum(t for t, _ in mine),
                             launches_recorded=recorded,
                             launches_expected=expected[label])
    busy = sum(t for t, _ in kern.values())
    wall = sum(walls) / n
    for sh in shares.values():
        sh["share"] = sh["ms"] / busy if kept else "not measured"
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    row = dict(run=run, steps=n, step_wall_ms=walls, losses=losses,
               records_kept=kept,
               device_busy_ms=busy if kept else "not measured",
               device_idle_share=1 - busy / wall if kept
               else "not measured",
               kernels_per_step=sum(c for _, c in kern.values()) / n,
               kernel_shares=shares,
               top=[{"name": k[:90], "ms_per_step": t,
                     "launches_per_step": c / n,
                     "share": t / busy if kept else "not measured"}
                    for k, (t, c) in top])
    emit("train_profile", **row)
    return row


def train_proc(args, ckpt_dir):
    """launch/train.py as a subprocess: (its completed process, wall
    seconds)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
           "--ckpt-dir", str(ckpt_dir)]
    env = dict(os.environ, PYTHONPATH=str(SRC),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=600)
    return res, time.perf_counter() - t0


def train_run(label, proc):
    """One ``train_proc`` read: (return code, {step: loss}, summary or
    None, wall seconds)."""
    res, wall = proc
    losses, summary = {}, None
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if "step" in d:
                losses[d["step"]] = d["loss"]
            if "done" in d:
                summary = d
    emit("train_resume_run", run=label, rc=res.returncode, losses=losses,
         seconds=round(wall, 2), stderr_tail=res.stderr[-600:]
         if res.returncode else "")
    return res.returncode, losses, summary, wall


# the grid's run of the drill (launch/train.py --grid): qwen2-0.5b at full
# width, 4 layers, bf16 weights and fp32 moments, cannon_opt on 2x2 PEs,
# 4 steps of 2 x 1024 tokens with a checkpoint every 2 steps
GRID_RESUME_ARGS = ["--arch", "qwen2-0.5b", "--full", "--layers", "4",
                    "--grid", "2x2", "--strategy", "cannon_opt", "--seq-len",
                    "1024", "--global-batch", "2", "--steps", "4",
                    "--ckpt-every", "2", "--log-every", "1",
                    "--deterministic"]
GRID_RESUME_FAIL = 3


def grid_resume_launches(label, summary, cfg, plan):
    """Every step of one grid launcher run (PE 0's counts, which the
    launcher holds equal on every PE): cannon_mm as
    :func:`grid_train_launches` reckons it, the heap kernels as
    ``grid_run.heap_launches`` reckons them from ``train_messages``, no
    plain version; returns the launches summed over the PEs."""
    want = {"matmul_cuda": grid_train_launches(cfg, "cannon_opt", plan)[
        "matmul_cuda"]}
    want.update({f"{k}_cuda": n for k, n in
                 summary["reckoned_heap_launches"].items()})
    check(summary["launches_equal_on_every_pe"]
          and summary["losses_equal_on_every_pe"],
          f"grid_train_resume {label}: the PEs' losses or launches differ")
    total = {}
    for k, n in zip(summary["steps"], summary["launches_per_step"]):
        plain = {name: v for name, v in n.items()
                 if name.endswith("_ref") and v}
        got = {name: n.get(name, 0) for name in want}
        check(got == want and not plain,
              f"grid_train_resume {label} step {k}: launches {got}, "
              f"expected {want}; plain {plain}")
        for name, v in got.items():
            total[name] = total.get(name, 0) + plan.n_pes * v
    check(summary["collectives_per_step"] == [summary[
        "reckoned_collectives"]] * len(summary["steps"])
        and summary["heap_bytes_per_pe"] == [summary["reckoned_heap_bytes"]],
        f"grid_train_resume {label}: collectives or heap bytes off the "
        f"reckoning")
    return total


def grid_resume_read(ckpt_dir, cfg, want_loss):
    """The 1x1 port reads the grid's step-1 checkpoint (its grid and
    storage from the meta) onto the card, and its loss on batch 2 is held
    against the grid's step-2 loss: (seconds to read, rel err)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import data_config
    from repro_torch.models.transformer import loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step, params, opt = ckpt.restore_train_state(str(ckpt_dir), step=1,
                                                 device=DEV)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    del opt
    dc = data_config(cfg, 1024, 2, True)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in make_batch(dc, 2, 0, 1).items()}
    with torch.no_grad():
        loss, _ = loss_fn(cfg, params, batch)
    err = abs(float(loss) - want_loss) / abs(want_loss)
    del params, batch
    torch.cuda.empty_cache()
    return read_s, err, float(loss)


def phase_train_resume(smi):
    """The fault drill of ``launch/train.py`` at 1x1 and on a 2x2 grid,
    the runs of both side by side (each process's start is most of its
    wall).

    At 1x1: ``--arch qwen2-0.5b --full --layers 4 --steps 6 --ckpt-every
    3`` (deterministic algorithms on), run straight and, beside it, with
    its step 4 (0-based) failing past the retry budget, which stops it
    after steps 0-3 with the checkpoint of step 2; then started again,
    resuming from that checkpoint.  The resumed steps 3-5 must give the
    straight run's losses bit for bit.

    grid_train_resume: the same on the grid (GRID_RESUME_ARGS, bf16 with
    fp32 moments): straight, and a drill whose step 3 fails, which exits
    non-zero after steps 0-2 and leaves the step-1 checkpoint in the
    grid's stored form (meta grid [2, 2]); the resumed run starts at step
    2 and its steps 2-3 give the straight run's losses bit for bit; every
    PE the same losses; cannon_mm on every GEMM and the heap kernels on
    every collective as reckoned, no plain version
    (:func:`grid_resume_launches`); the 1x1 port reads the step-1
    checkpoint and its loss on batch 2 is within the bf16 loss gate
    (GRID_TRAIN_BF16_TOL's loss2) of the grid's step-2 loss.  Prints each
    run's seconds, the checkpoint's bytes, its write and read seconds.
    Returns the grid runs' launches summed over the PEs."""
    from repro_torch.launch.train import train_config
    from repro_torch.partition import grid_plan
    base = ["--arch", "qwen2-0.5b", "--full", "--layers", "4", "--steps",
            "6", "--ckpt-every", "3", "--log-every", "1", "--deterministic"]
    root = ROOT / "build" / "smoke_train_ckpt"
    groot = ROOT / "build" / "smoke_grid_ckpt"
    for d in (root, groot):
        shutil.rmtree(d, ignore_errors=True)
    grid_fail = ["--fail-at-step", str(GRID_RESUME_FAIL)]
    with ThreadPoolExecutor(4) as ex:
        runs = [ex.submit(train_proc, base, root / "straight"),
                ex.submit(train_proc, base + ["--fail-at-step", "4"],
                          root / "resumed"),
                ex.submit(train_proc, GRID_RESUME_ARGS, groot / "straight"),
                ex.submit(train_proc, GRID_RESUME_ARGS + grid_fail,
                          groot / "resumed")]
        runs = [f.result() for f in runs]
    rc, straight, _, _ = train_run("straight", runs[0])
    check(rc == 0 and sorted(straight) == list(range(6)),
          f"train_resume: the straight run failed ({rc}): {straight}")
    rc, failed, _, _ = train_run("failed at step 4", runs[1])
    check(rc != 0 and sorted(failed) == [0, 1, 2, 3],
          f"train_resume: the drill did not stop after step 3 ({rc}): "
          f"{failed}")
    rc, g_straight, g_sum, g_s_wall = train_run("grid straight", runs[2])
    check(rc == 0 and sorted(g_straight) == [0, 1, 2, 3],
          f"grid_train_resume: the straight run failed ({rc}): {g_straight}")
    rc, g_failed, g_fsum, g_f_wall = train_run(
        f"grid failed at step {GRID_RESUME_FAIL}", runs[3])
    drill = g_fsum and {k: g_fsum[k] for k in ("stopped_at", "ckpt_step",
                                                 "retries")}
    check(rc != 0 and sorted(g_failed) == [0, 1, 2] and drill
          and drill["stopped_at"] == GRID_RESUME_FAIL
          and drill["ckpt_step"] == 1,
          f"grid_train_resume: the drill did not stop after step 2 with "
          f"the step-1 checkpoint ({rc}): {g_failed}, {drill}")
    with open(groot / "resumed" / "step_00000001" / "manifest.json") as f:
        meta = json.load(f)["meta"]
    check(meta.get("grid") == [2, 2],
          f"grid_train_resume: the step-1 checkpoint's meta is {meta}")
    with ThreadPoolExecutor(2) as ex:
        again = [ex.submit(train_proc, base, root / "resumed"),
                 ex.submit(train_proc, GRID_RESUME_ARGS, groot / "resumed")]
        again = [f.result() for f in again]
    rc, resumed, summary, _ = train_run("resumed", again[0])
    check(rc == 0 and summary and summary["start_step"] == 3
          and sorted(resumed) == [3, 4, 5],
          f"train_resume: the resumed run ({rc}) did not run steps 3-5 "
          f"from the step-2 checkpoint: {summary}")
    same = {s: resumed[s] == straight[s] for s in (3, 4, 5)}
    emit("train_resume", straight=straight, failed=failed, resumed=resumed,
         identical=same)
    check(all(same.values()), f"train_resume: resumed losses {resumed} "
                              f"differ from the straight run's {straight}")
    check(all(failed[s] == straight[s] for s in failed),
          "train_resume: the drill's steps 0-3 differ from the straight run")
    rc, g_resumed, g_rsum, g_r_wall = train_run("grid resumed", again[1])
    check(rc == 0 and g_rsum and g_rsum["start_step"] == 2
          and sorted(g_resumed) == [2, 3],
          f"grid_train_resume: the resumed run ({rc}) did not run steps 2-3 "
          f"from the step-1 checkpoint: {g_rsum}")
    g_same = {s: g_resumed[s] == g_straight[s] for s in (2, 3)}
    check(all(g_same.values()) and all(g_failed[s] == g_straight[s]
                                       for s in g_failed),
          f"grid_train_resume: resumed {g_resumed} / drill {g_failed} "
          f"against the straight run's {g_straight}")
    cfg = train_config("qwen2-0.5b", True, 4)
    plan = grid_plan(2, 2)
    launches = {}
    for label, sm in (("straight", g_sum), ("drill", g_fsum),
                      ("resumed", g_rsum)):
        for k, n in grid_resume_launches(label, sm, cfg, plan).items():
            launches[k] = launches.get(k, 0) + n
    read_s, err, loss_1x1 = grid_resume_read(groot / "resumed", cfg,
                                             g_straight[2])
    tol = GRID_TRAIN_BF16_TOL["qwen2-0.5b bf16"]["loss2"]
    saves = g_sum["checkpoints"] + g_fsum["checkpoints"] \
        + g_rsum["checkpoints"]
    emit("grid_train_resume", straight=g_straight, failed=g_failed,
         resumed=g_resumed, identical=g_same, meta=meta,
         seconds={"straight": round(g_s_wall, 2), "drill": round(g_f_wall, 2),
                  "resumed": round(again[1][1], 2)},
         ckpt_bytes=saves[0]["bytes"],
         ckpt_write_s={f"{lab} step {c['step']}": round(c["seconds"], 3)
                       for lab, sm in (("straight", g_sum), ("drill", g_fsum),
                                       ("resumed", g_rsum))
                       for c in sm["checkpoints"]},
         ckpt_read_s_grid=round(g_rsum["restored"]["seconds"], 3),
         ckpt_read_s_1x1=round(read_s, 3), loss_1x1_on_batch2=loss_1x1,
         loss_1x1_rel_err=err, loss_tol=tol,
         ms_per_step=g_sum["ms_per_step"], launches=launches, nvidia_smi=smi)
    check(err <= tol, f"grid_train_resume: the 1x1 port's loss {loss_1x1} "
                      f"on the step-1 checkpoint is {err} from the grid's "
                      f"step-2 loss {g_straight[2]} (limit {tol})")
    for d in (root, groot):
        shutil.rmtree(d, ignore_errors=True)
    return launches


# the dry run's cells checked on the card (arch, shape, options, layers,
# batch): qwen2-0.5b decode_32k at full depth and the largest batch of 32
# that the account puts well under the share (128 does not fit: the fixed
# path repeats K and V in fp32 beside the 51.5 GB cache); qwen3-moe
# train_4k at 2 layers, 8-bit moments and batch 2, the grouped GEMM's
# forward and backward; mamba2-780m prefill_32k at full depth, batch 4
DRYRUN_VERIFY = (("qwen2-0.5b", "decode_32k", {}, None, 96),
                 ("qwen3-moe-235b-a22b", "train_4k", {"state_bits": 8}, 2, 2),
                 ("mamba2-780m", "prefill_32k", {}, None, 4))
DRYRUN_PEAK_TOL = 0.15       # measured peak within 15 % of the reckoned one
DRYRUN_JOBS = 6              # processes that count the 40 cells


def phase_dryrun(smi):
    """``python -m repro_torch.launch.dryrun --all`` (the 40 cells on meta,
    counted at 2 and 3 layer groups, in DRYRUN_JOBS processes) in the
    background while ``dryrun.verify_cell`` runs DRYRUN_VERIFY's cells on
    the card here.  Gates: every cell ok or skipped with applicable's
    reason, a cell that fits reports at least its depth in max_layers; each
    verified cell's measured peak within DRYRUN_PEAK_TOL of the reckoned
    one and its counted FLOPs over the step wall below the card's peak for
    its dtype; the grouped GEMM's launches on the qwen3-moe step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import applicable, SHAPE_BY_NAME
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = ROOT / "build" / "smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    log = open(ROOT / "build" / "smoke_dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), "--out", str(out)],
        stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    try:
        verified, counts = [], {}
        for arch, shape, kw, layers, batch in DRYRUN_VERIFY:
            counters = zero_counts()
            grad = grad_fns()
            for kern, _ in grad.values():
                kern.launches = 0
            row = dryrun.verify_cell(arch, shape, dryrun.Options(**kw),
                                     layers=layers, batch=batch, device=DEV)
            row["launches"] = {name: kern.launches for name, (kern, _) in
                               {**counters, **grad}.items() if kern.launches}
            row["plain_launches"] = sum(p.launches for _, p in
                                        {**counters, **grad}.values())
            row["nvidia_smi"] = smi
            emit("dryrun_verify", **row)
            verified.append(row)
            for name, n in row["launches"].items():
                counts.setdefault(name, {})[f"dryrun {arch} {shape}"] = n
            check(abs(row["peak_ratio"] - 1) <= DRYRUN_PEAK_TOL,
                  f"dryrun: {arch} {shape} measured peak "
                  f"{row['measured_peak_bytes']} against the reckoned "
                  f"{row['reckoned_peak_bytes']}")
            check(row["tflops_s"] < row["peak_tflops_s"],
                  f"dryrun: {arch} {shape} reads {row['tflops_s']} TFLOP/s")
            check(row["plain_launches"] == 0,
                  f"dryrun: {arch} {shape} ran a plain version")
        moe = verified[1]["launches"]
        check(all(moe.get(n) for n in ("grouped_mm", "grouped_mm_swiglu",
                                       "grouped_mm_dgrad",
                                       "grouped_mm_wgrad")),
              f"dryrun: the qwen3-moe step missed a grouped GEMM: {moe}")
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (ROOT / "build" / "smoke_dryrun.log").read_text()
    check(rc == 0, f"dryrun --all exited {rc}: {text[-2000:]}")
    cells = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
    check(len(cells) == 40, f"dryrun --all wrote {len(cells)} cells")
    for c in cells:
        cfg = get_config(c["arch"])
        ok, reason = applicable(cfg, SHAPE_BY_NAME[c["shape"]])
        check(c["status"] == ("ok" if ok else "skipped")
              and c.get("reason", "") == reason,
              f"dryrun: cell {c['arch']} {c['shape']}: {c['status']}")
        if c["status"] != "ok":
            emit("dryrun_cell", arch=c["arch"], shape=c["shape"],
                 status=c["status"], reason=c["reason"])
            continue
        emit("dryrun_cell", **{k: c[k] for k in (
            "arch", "shape", "status", "n_layers", "batch", "flops",
            "grouped_mm", "param_bytes", "resident_bytes", "peak_bytes",
            "fits", "max_layers", "max_batch", "roofline", "device",
            "memory_bytes")})
        check(not c["fits"] or c["max_layers"] >= c["n_layers"],
              f"dryrun: {c['arch']} {c['shape']} fits with max_layers "
              f"{c['max_layers']} below its {c['n_layers']}")
    emit("dryrun", cells=len(cells), ok=sum(c["status"] == "ok"
                                            for c in cells),
         fits=[f"{c['arch']} {c['shape']}" for c in cells if c.get("fits")],
         all_seconds=next((json.loads(ln)["seconds"] for ln in
                           text.splitlines() if ln.startswith("{")), None),
         seconds=round(time.perf_counter() - t0, 2))
    return counts


def phase_examples():
    """The three examples on the card at small sizes, in this process
    (``main`` returning is the exit 0): quickstart (n 256) must launch
    cannon_mm, serve_decode (2 layers) paged_attention, no plain version
    anywhere; train_lm (2 layers of the ~100M LM, 12 steps) must lower the
    loss, and a second run resume from its checkpoint."""
    from repro_torch.examples import quickstart, serve_decode, train_lm
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    t0 = time.perf_counter()
    counters = {**kernel_counters(),
                "cannon_mm": (matmul_cuda, matmul_ref)}
    counts, rows = {}, {}

    def run(name, fn, argv, must):
        for kern, plain in counters.values():
            kern.launches = plain.launches = 0
        t = time.perf_counter()
        out = fn(argv)
        got = {k: kern.launches for k, (kern, _) in counters.items()
               if kern.launches}
        plain = {k: p.launches for k, (_, p) in counters.items()
                 if p.launches}
        rows[name] = dict(launches=got, plain=plain,
                          seconds=round(time.perf_counter() - t, 2))
        check(all(got.get(k) for k in must) and not plain,
              f"examples: {name} launched {got}, plain {plain}")
        for k, n in got.items():
            counts.setdefault(k, {})[f"{name} example"] = n
        return out

    q = run("quickstart", quickstart.main, ["--n", "256"], ("cannon_mm",))
    # fp32 sums of 256 products against the host's fp64 product
    check(max(q["max_err"].values()) <= 1e-3, f"quickstart: {q['max_err']}")
    s = run("serve_decode", serve_decode.main,
            ["--layers", "2", "--tokens", "8"], ("paged_attention",))
    check(all(len(c.tokens) == 8 for c in s["engine"]),
          "serve_decode: short completions")
    ckpt = ROOT / "build" / "smoke_example_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--layers", "2", "--ckpt", str(ckpt), "--ckpt-every", "6",
            "--lr", "1e-3", "--warmup", "3"]
    t = run("train_lm", train_lm.main, args + ["--steps", "12"], ())
    r = run("train_lm resumed", train_lm.main, args + ["--steps", "18"], ())
    check(r["start"] == 12 and [s_ for s_, _ in r["losses"]]
          == list(range(12, 18)), f"train_lm: resumed at {r['start']}")
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("examples", runs=rows, quickstart_max_err=q["max_err"],
         train_losses=[round(l_, 4) for _, l_ in t["losses"] + r["losses"]],
         seconds=round(time.perf_counter() - t0, 2))
    return counts


def checking_engine():
    """ServingEngine that refuses any non-finite logits row it samples,
    the verify rows of its speculative rounds included, while its
    ``checking`` is on (a pass timed for tokens/s turns it off: the check
    reads every row on the host, five per slot in a verify round)."""
    from repro_torch.serve.engine import ServingEngine

    class Checked(ServingEngine):
        checking = True

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if self.spec is not None:
                check_verify_rows(self.spec)

        def _commit(self, sd, rows, fed, skip=frozenset()):
            live = [s for s, r in enumerate(sd.slots)
                    if r is not None and s not in skip]
            check(not self.checking or bool(np.isfinite(rows[live]).all()),
                  "non-finite logits row")
            super()._commit(sd, rows, fed, skip=skip)
    return Checked


def check_verify_rows(spec):
    """Make ``spec`` refuse a round whose verify rows (those its slots fed)
    hold a non-finite logit."""
    commit = spec.commit

    def checked(rnd, rows, skip=frozenset()):
        for s, r in enumerate(rnd.sd.slots):
            check(r is None or s in skip or not spec.eng.checking or bool(
                np.isfinite(rows[s, :rnd.fed[s]]).all()),
                "non-finite verify logits row")
        commit(rnd, rows, skip=skip)
    spec.commit = checked


def to_dtype(tree, dtype):
    """A copy of a weight tree with every floating leaf cast to dtype."""
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


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
    reference_speculation(cfg, runs, prompts, tokens["kernel"],
                          self_draft=not specs.has_dense)


def reference_speculation(cfg, runs, prompts, plain_tokens, self_draft):
    """``cfg`` (fp32) served with n-gram speculation (k = 4) on the card
    and on the CPU, and without it on the card, over repetitive prompts:
    the greedy tokens of the three must be identical, and the two
    speculative runs' counters too.  An attention-only config then
    self-drafts on the card through ``DraftModelDrafter`` with its own
    weights (buckets 1, as tests/test_speculative.py:289): every draft
    token must be accepted and the tokens must be the plain run's."""
    from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                          generate)
    from repro_torch.serve.spec import DraftModelDrafter, SpeculationConfig
    ngram = SpeculationConfig("ngram", k=SPEC_K)
    work = spec_prompts(cfg.vocab_size, lens=(12, 20, 7, 30))
    sampling = SamplingParams(max_tokens=16)
    tokens, stats = {}, {}
    for label, dev, params, speculation in (
            ("card_spec", "cuda", runs["kernel"][1], ngram),
            ("cpu_spec", "cpu", runs["plain"][1], ngram),
            ("card_plain", "cuda", runs["kernel"][1], None)):
        ec = EngineConfig(s_max=64, buckets=(1, 2, 4), block_pos_stride=4,
                          prefill_chunks=(4, 16), device=dev,
                          speculation=speculation)
        eng = checking_engine()(cfg, params=params, engine_cfg=ec)
        tokens[label] = [c.tokens for c in generate(eng, work, sampling)]
        stats[label] = {k: v for k, v in dataclasses.asdict(eng.stats)
                        .items() if k.startswith(("spec_", "decode_",
                                                  "prefill_"))}
    check(tokens["card_spec"] == tokens["cpu_spec"] == tokens["card_plain"],
          f"{cfg.name}: speculative tokens differ: {tokens}")
    check(stats["card_spec"] == stats["cpu_spec"],
          f"{cfg.name}: speculative counters differ, card and cpu: {stats}")
    check(stats["card_spec"]["spec_launches"] > 0,
          f"{cfg.name}: no verify launch in the speculative run")
    row = dict(config=cfg.name, tokens_match=True, spec=stats["card_spec"])
    if self_draft:
        ec = EngineConfig(s_max=64, buckets=(1,), block_pos_stride=4,
                          prefill_chunks=(4, 16), device="cuda",
                          speculation=SpeculationConfig("ngram", k=3))
        eng = checking_engine()(cfg, params=runs["kernel"][1],
                                engine_cfg=ec)
        drafter = DraftModelDrafter(cfg, s_max=64, stride=4,
                                    params=eng.params, chunk=8,
                                    device="cuda")
        set_drafter(eng, drafter)
        got = [c.tokens for c in generate(eng, prompts,
                                          SamplingParams(max_tokens=8))]
        st = eng.stats
        check(got == plain_tokens, f"{cfg.name}: self-drafted tokens "
              f"differ: {got} != {plain_tokens}")
        check(st.spec_proposed_tokens > 0 and st.spec_accept_rate == 1.0,
              f"{cfg.name}: self-draft accepted {st.spec_accepted_tokens} "
              f"of {st.spec_proposed_tokens}")
        row.update(self_draft_proposed=st.spec_proposed_tokens,
                   self_draft_accept_rate=st.spec_accept_rate,
                   draft_launches=drafter.n_launches,
                   draft_graphs=drafter.queue.n_executables)
    emit("reference_speculation", **row)


def phase_reference():
    """The five fp32 reference configs.  Their scans take the two SSD
    passes on the CUDA cores (fp32 x: kernel.py::plan's simt variant), and
    their experts the grouped GEMM's simt variant, the first product fused
    with its epilogue (``grouped_mm_swiglu``): the counts are set to 0 just
    before and read just after, and each must have run, every launch on
    simt, the fused scan never.  Each check also serves the config on the
    CPU through the plain versions; their counts are reported, not
    checked."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.grouped_mm import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda)
    from repro_torch.kernels.ssd_scan.ref import (ssd_apply_ref,
                                                  ssd_chunk_ref,
                                                  ssd_scan_fused_ref)
    mamba = reduced(get_config("mamba2-780m"))
    check((mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_groups,
           mamba.ssm_state) == tuple(REDUCED_GEOM.values()),
          "the reduced mamba2 geometry is not REDUCED_GEOM")
    ssd = {k: v for k, v in kernel_counters().items() if k in SSD_KERNELS}
    for kern, _ in ssd.values():
        kern.launches = 0
    two_pass = [ssd[k][0] for k in ("ssd_chunk", "ssd_apply")]
    gmms = {"grouped_mm": grouped_mm_cuda,
            "grouped_mm_swiglu": grouped_mm_swiglu_cuda}
    for kern in two_pass + list(gmms.values()):
        kern.by_variant = {v: 0 for v in kern.by_variant}
    for kern in gmms.values():
        kern.launches = 0
    for cfg in (reduced(get_config("qwen2-0.5b")), mamba, hybrid_config(),
                reduced(get_config("qwen3-moe-235b-a22b")),
                reduced(get_config("jamba-1.5-large-398b"))):
        reference_check(cfg)
    launches = {k: kern.launches for k, (kern, _) in ssd.items()}
    by_variant = {k: dict(ssd[k][0].by_variant)
                  for k in ("ssd_chunk", "ssd_apply")}
    check(launches["ssd_chunk"] > 0 and launches["ssd_apply"] > 0
          and launches["ssd_scan_fused"] == 0,
          f"the fp32 reference scans did not take the two passes: "
          f"{launches}")
    check(all(v["simt"] == launches[k] for k, v in by_variant.items()),
          f"the fp32 reference scans left the simt variant: {by_variant}")
    for name, kern in gmms.items():
        gmm = dict(kern.by_variant)
        check(kern.launches > 0 and gmm["simt"] == kern.launches,
              f"the fp32 reference experts did not take the simt {name}: "
              f"{kern.launches} launches, {gmm}")
        launches[name] = kern.launches
        by_variant[name] = gmm
    check(launches["grouped_mm"] == launches["grouped_mm_swiglu"],
          f"the MoE layers' two products ran unequally: {launches}")
    emit("reference_kernel_launches", **launches, by_variant=by_variant,
         plain_on_cpu={f.__name__: f.launches for f in (
             ssd_chunk_ref, ssd_apply_ref, ssd_scan_fused_ref,
             grouped_mm_ref, grouped_mm_swiglu_ref)})
    return launches


def spec_prompts(vocab, lens=PROMPT_LENS):
    """Repetitive prompts, built as tests/test_speculative.py:49 builds
    them: tiled patterns of 2-4 tokens from ``default_rng(0)``, cut to
    ``lens``."""
    rng = np.random.default_rng(0)
    out = []
    for n in lens:
        pat = rng.integers(0, vocab, size=int(rng.integers(2, 5))).tolist()
        out.append((pat * -(-n // len(pat)))[:n])
    return out


def kernel_counters():
    """name -> (the wrapper whose count is the kernel's launches, the plain
    version that must not run on the main path)."""
    from repro_torch.kernels.grouped_mm import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda,
                                                     ssd_scan_fused_cuda)
    from repro_torch.kernels.ssd_scan.ref import (ssd_apply_ref,
                                                  ssd_chunk_ref,
                                                  ssd_scan_fused_ref)
    return {"paged_attention": (paged_attention_cuda, paged_attention_ref),
            "ssd_chunk": (ssd_chunk_cuda, ssd_chunk_ref),
            "ssd_apply": (ssd_apply_cuda, ssd_apply_ref),
            "ssd_scan_fused": (ssd_scan_fused_cuda, ssd_scan_fused_ref),
            "grouped_mm": (grouped_mm_cuda, grouped_mm_ref),
            "grouped_mm_swiglu": (grouped_mm_swiglu_cuda,
                                  grouped_mm_swiglu_ref)}


def smoke_ec(**kw):
    """The smoke's engine setting, with ``kw`` added."""
    from repro_torch.serve.engine import EngineConfig
    return EngineConfig(s_max=512, buckets=(1, 2, 4, 8), block_pos_stride=16,
                        prefill_chunks=(16, 64, 256), device="cuda", **kw)


def zero_counts():
    """Every kernel's and plain version's count to 0 (the variants' too);
    returns ``kernel_counters()``."""
    counters = kernel_counters()
    for kern, plain in counters.values():
        kern.launches = plain.launches = 0
        if hasattr(kern, "by_variant"):
            kern.by_variant = dict.fromkeys(kern.by_variant, 0)
    return counters


def run_pass(eng, label, serve_fn, queue_kind):
    """One pass of ``serve_fn()`` on fresh ``EngineStats`` and event
    stamps; checks every request ended ``"length"`` with its tokens and
    returns (the pass's numbers, its greedy tokens, its EngineStats)."""
    from repro_torch.serve.engine import EngineStats
    eng.stats = EngineStats()
    for ev in eng.kernel_events().values():
        ev.first_enqueue_t = ev.last_enqueue_t = ev.last_done_t = 0.0
    t0 = time.perf_counter()
    outs = serve_fn()
    wall = time.perf_counter() - t0
    st = eng.stats
    for c in outs:
        check(c.finish_reason == "length" and len(c.tokens) == MAX_TOKENS,
              f"{c.request_id}: {c.finish_reason} after "
              f"{len(c.tokens)} tokens")
    ttft = [c.ttft_s for c in outs]
    row = dict(
        wall_s=wall, tokens=st.tokens_generated,
        tokens_per_s=eng.throughput_tok_s(),
        mean_ttft_ms=1e3 * float(np.mean(ttft)),
        launches=st.launches, decode_launches=st.decode_launches,
        prefill_launches=st.prefill_launches,
        prefill_chunk_launches=st.prefill_chunk_launches,
        spec_launches=st.spec_launches,
        tokens_per_launch=st.tokens_generated / max(st.launches, 1),
        prompt_tokens_ingested=st.prompt_tokens_ingested,
        prefix_hits=st.prefix_hits, prefix_hit_rate=st.prefix_hit_rate,
        peak_dense_slots_used=st.peak_dense_slots_used,
        peak_kv_bytes=eng.peak_kv_bytes())
    emit("engine_pass", config=eng.cfg.name, run=label, queue=queue_kind,
         **row)
    return row, [c.tokens for c in outs], dataclasses.asdict(st)


def serve_passes(eng, cfg, prompts, arrivals, sampling,
                 queue_kind="graphs"):
    """Cold, warm and one-per-step arrival passes; returns per-pass stats,
    the engine launches of all three (by kind), the steps that ran and
    each pass's greedy tokens and ``EngineStats``."""
    from repro_torch.serve.engine import completion_of, generate

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

    passes, outputs = {}, {}
    totals = {"launches": 0, "prefill_chunk_launches": 0}
    for label, serve_fn, batch in (("cold", at_once, prompts),
                                   ("warm", at_once, prompts),
                                   ("arrivals", one_per_step, arrivals)):
        passes[label], tokens, stats = run_pass(
            eng, label, lambda: serve_fn(batch), queue_kind)
        totals["launches"] += stats["decode_launches"] \
            + stats["prefill_launches"] + stats["spec_launches"]
        totals["prefill_chunk_launches"] += stats["prefill_chunk_launches"]
        outputs[label] = (tokens, stats)
    names = sorted(eng.kernel_events())
    for L in (16, 64, 256):
        check(any(n.endswith(f"_len{L}") for n in names),
              f"no prefill_bs*_len{L} step ran: {names}")
    check(any(n.startswith("serve_step_bs") for n in names),
          f"no serve_step_bs* step ran: {names}")
    return passes, totals, names, outputs


# full-width models served with their depth cut, to fit one card
ENGINE_LAYERS = {"qwen3-moe-235b-a22b": 8}


def phase_engine(arch):
    """The main path of one full-width model: its kernels' counts are set
    to 0 just before the three passes and read just after.  An attention
    layer launches the paged-attention kernel on every engine launch; a
    mamba layer (bf16, state 128, the engine's one chunk) launches the fused
    scan on every chunk launch and the two passes never, and decode runs
    the one-token recurrence; an MoE layer launches the grouped GEMM twice
    on every engine launch: w1 fused with the silu x up epilogue
    (``grouped_mm_swiglu``), then w2 (``grouped_mm``), each on the variant
    that kernel.py::plan names for the step's rows (``moe_routes``).
    Returns (launches, engine, prompts, arrivals, sampling, outputs, the
    grouped GEMM's launches by variant and by step)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import (config_param_bytes, init_params,
                                           param_bytes)
    from repro_torch.serve.engine import SamplingParams
    cfg = get_config(arch)
    if arch in ENGINE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=ENGINE_LAYERS[arch])
    widths = {"qwen2-0.5b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.d_ff, cfg.vocab_size), (24, 896, 14, 2, 64, 4864, 151936)),
        "mamba2-780m": (
        (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
         cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups, cfg.conv_kernel,
         cfg.vocab_size), (48, 1536, 3072, 48, 64, 128, 1, 4, 50280)),
        "qwen3-moe-235b-a22b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.qk_norm, cfg.n_experts, cfg.top_k, cfg.d_ff_expert,
         cfg.vocab_size), (8, 4096, 64, 4, 64, True, 128, 8, 1536, 151936)),
        "qwen2-7b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.d_ff, cfg.vocab_size, cfg.qkv_bias),
        (28, 3584, 28, 4, 128, 18944, 152064, True)),
        "stablelm-12b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.d_ff, cfg.vocab_size, cfg.norm),
        (40, 5120, 32, 8, 160, 13824, 100352, "layernorm")),
        "pixtral-12b": (
        (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
         cfg.d_ff, cfg.vocab_size, cfg.vis_patches),
        (40, 5120, 32, 8, 160, 14336, 131072, 1024))}
    got, want = widths[arch]
    check(got == want, f"{arch} is not at its config's full width: {got}")
    check(cfg.compute_dtype == torch.bfloat16,
          f"{arch} computes in {cfg.compute_dtype}, not bf16")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(param_bytes(params) == config_param_bytes(cfg),
          f"{arch}: the reckoned weight bytes {config_param_bytes(cfg)} "
          f"are not the allocated {param_bytes(params)}")
    eng = checking_engine()(cfg, params=params, engine_cfg=smoke_ec())
    emit("engine_setup", config=cfg.name, n_layers=cfg.n_layers,
         init_s=init_s, param_bytes=param_bytes(params),
         arena_bytes=eng.store.arena_bytes(), n_kv_blocks=eng.pool.n_blocks,
         dense_slot_bytes=eng.store.dense_slot_bytes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]
    # same lengths, fresh tokens: the arrivals pass misses the prefix cache
    arrivals = [rng.integers(0, cfg.vocab_size, n).tolist()
                for n in PROMPT_LENS]
    sampling = SamplingParams(max_tokens=MAX_TOKENS)

    counters = zero_counts()                   # every count to 0 ...
    steps0 = {n: ev.launches for n, ev in eng.kernel_events().items()}
    passes, totals, names, outputs = serve_passes(eng, cfg, prompts,
                                                  arrivals, sampling)
    launches = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: p.launches for k, (_, p) in counters.items()}  # ... read
    steps = {n: ev.launches - steps0.get(n, 0)
             for n, ev in eng.kernel_events().items()}
    routes = moe_routes(cfg, steps, counters)
    for name, r in routes.items():
        r["plain_launches"] = plain[name]
    graphs = check_graphs(eng)
    mixers = [m for m, _ in cfg.pattern()]
    # bf16 at N 128 and the engine's one chunk: every mamba layer of every
    # chunk launch is one fused scan, and the two passes never run
    scans = mixers.count("mamba") * totals["prefill_chunk_launches"]
    ffns = [f for _, f in cfg.pattern()]
    moe = ffns.count("moe") * totals["launches"]
    per_group = {"paged_attention": mixers.count("attn") * totals["launches"],
                 "ssd_chunk": 0, "ssd_apply": 0, "ssd_scan_fused": scans,
                 "grouped_mm": moe, "grouped_mm_swiglu": moe}
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
         graphs=graphs, warm=passes["warm"], grouped_mm_routes=routes)
    return launches, eng, prompts, arrivals, sampling, outputs, routes


def step_tokens(name):
    """Token rows of one launch of a step: ``serve_step_bs{N}`` N,
    ``prefill_bs{N}_len{L}`` and ``verify_bs{N}_len{L}`` N * L."""
    parts = name.split("_")
    bs = next(int(p[2:]) for p in parts if p.startswith("bs"))
    return bs * next((int(p[3:]) for p in parts if p.startswith("len")), 1)


def moe_routes(cfg, steps, counters):
    """The grouped GEMM's launches by variant against what kernel.py::plan
    names for each step's M = tokens * top_k rows, every MoE layer of every
    launch: they must agree, variant by variant, for the fused first
    product and for w2.  Returns {wrapper: {"by_variant", "by_step"}} ({}
    for a model without MoE layers)."""
    from repro_torch.kernels.grouped_mm.kernel import route
    n_moe = cfg.n_groups() * [f for _, f in cfg.pattern()].count("moe")
    if not n_moe:
        return {}
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {}
    for name, K, N, swiglu in (("grouped_mm_swiglu", D, 2 * F, True),
                               ("grouped_mm", F, D, False)):
        by_step, want = {}, {}
        for step, n in sorted(steps.items()):
            if not n:
                continue
            v = route(cfg.compute_dtype, step_tokens(step) * cfg.top_k, K, N,
                      E, swiglu)
            by_step[step] = dict(variant=v, launches=n * n_moe)
            want[v] = want.get(v, 0) + n * n_moe
        got = {v: c for v, c in counters[name][0].by_variant.items() if c}
        check(got == want, f"{cfg.name}: {name} launches by variant {got} "
              f"!= {want}, what plan names for the steps that ran")
        slow = [st for st, r in by_step.items() if st.endswith("_len256")
                and r["variant"] != "wgmma_tma"]
        check(cfg.compute_dtype != torch.bfloat16 or not slow,
              f"{cfg.name}: {name} left wgmma_tma on len256 steps {slow}")
        out[name] = dict(by_variant=got, by_step=by_step)
    return out


def check_graphs(eng):
    """Every step the engine launched is one CUDA graph, built once: the
    queue holds one executable per distinct (bucket, L) step that ran, each
    a StepGraph with its build time stamped."""
    from repro_torch.core.hybrid import StepGraph
    events = eng.kernel_events()
    ran = sorted(n for n, ev in events.items() if ev.launches)
    exes = eng.queue._compiled
    check(eng.queue.n_executables == len(ran) and sorted(exes) == ran,
          f"graphs built {sorted(exes)} != steps that ran {ran}")
    check(all(isinstance(e, StepGraph) for e in exes.values()),
          "a step of the engine is not a captured graph")
    check(all(events[n].build_time_s > 0 for n in ran),
          "a step has no build time")
    return dict(n=len(ran), build_s=sum(events[n].build_time_s for n in ran),
                max_build_s=max(events[n].build_time_s for n in ran))


def eager_engine():
    """``checking_engine`` on a queue whose build makes each step body,
    run eagerly on operands uploaded at every enqueue, its executable: the
    engine as it was before its steps were captured."""
    from repro_torch.core import CommandQueue

    class EagerQueue(CommandQueue):
        def _executable(self, fn, example_args):
            dev = self.device

            def run(*args):
                return fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a
                            for a in args))
            return run

    class Eager(checking_engine()):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.queue = EagerQueue(self.device)
    return Eager


def phase_graphs(eng, prompts, arrivals, sampling, outputs):
    """The same engine on the same weights and workload, every step run
    eagerly: each pass's greedy tokens and ``EngineStats`` must equal those
    of the engine that replays graphs (``outputs``)."""
    ec = eng.engine_cfg
    eager = eager_engine()(eng.cfg, params=eng.params, engine_cfg=ec)
    passes, _, _, got = serve_passes(eager, eng.cfg, prompts, arrivals,
                                     sampling, queue_kind="eager")
    for label, (tokens, stats) in outputs.items():
        check(got[label][0] == tokens,
              f"{eng.cfg.name} {label}: replayed tokens differ from eager "
              f"ones")
        check(got[label][1] == stats,
              f"{eng.cfg.name} {label}: EngineStats differ: graphs {stats} "
              f"eager {got[label][1]}")
    emit("graphs", config=eng.cfg.name, tokens_match=True, stats_match=True,
         eager_warm=passes["warm"])
    del eager
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Speculative decoding at full width.
# ---------------------------------------------------------------------------

SPEC_MARGIN = 0.02      # top-2 margin / row std below which greedy may flip


def record_rows(eng):
    """Record, per (prompt, output index), the logits row each committed
    token came from: every row the plain sampler draws from, or, with
    speculation, every verify row a round commits.  Returns the dict the
    wrapper fills (rows copied: the engine reuses its buffers) and a
    function that takes the wrapper off."""
    rec = {}
    if eng.spec is None:
        sample = eng._sample

        def sampled(req, row):
            rec[(tuple(req.prompt), len(req.output_tokens))] = row.copy()
            return sample(req, row)
        eng._sample = sampled
        return rec, lambda: delattr(eng, "_sample")
    commit = eng.spec.commit

    def committed(rnd, rows, skip=frozenset()):
        n0 = {s: (r, len(r.output_tokens))
              for s, r in enumerate(rnd.sd.slots) if r is not None}
        commit(rnd, rows, skip=skip)
        for s, (r, n) in n0.items():
            for j in range(len(r.output_tokens) - n):
                rec[(tuple(r.prompt), n + j)] = rows[s, j].copy()
    eng.spec.commit = committed
    return rec, lambda: setattr(eng.spec, "commit", commit)


WARM_TIMED = ("warm", "warm2", "warm3")


def spec_passes(eng, prompts, sampling, queue_kind):
    """The speculation workload: a cold pass, three warm passes (timed: no
    rows recorded or checked on the host; the host clock spreads, so the
    median is the one reported), and the warm pass again with every
    committed row recorded and checked.  Every warm pass must give the
    same tokens.  Returns per-pass numbers (``warm`` holding the median
    tokens/s and TTFT of the timed ones), tokens and ``EngineStats``, and
    the recorded rows of the cold and warm passes."""
    from repro_torch.serve.engine import generate
    passes, outputs, recs = {}, {}, {}
    drafter = eng.spec.drafter if eng.spec is not None else None
    for label in ("cold",) + WARM_TIMED + ("warm_rec",):
        if isinstance(drafter, ReplayDrafter):
            drafter.plain = drafter.tables[label[:4]]
        timed = label in WARM_TIMED
        if not timed:
            rec, unwrap = record_rows(eng)
            recs[label[:4]] = rec
        eng.checking = not timed
        passes[label], tokens, stats = run_pass(
            eng, label, lambda: generate(eng, prompts, sampling), queue_kind)
        eng.checking = True
        outputs[label] = (tokens, stats)
        if not timed:
            unwrap()
        check(label[:4] != "warm" or tokens == outputs["warm"][0],
              f"{eng.cfg.name}: warm pass {label} gave other tokens")
    for key in ("tokens_per_s", "mean_ttft_ms"):
        runs = [passes[label][key] for label in WARM_TIMED]
        passes["warm"][key + "_runs"] = runs
        passes["warm"][key] = float(np.median(runs))
    return passes, outputs, recs


def greedy_against_plain(prompts, plain, spec, plain_rows, verify_rows):
    """Per request: the first index where the speculative tokens leave the
    plain ones (None: identical), that position's plain top-2 margin over
    its row's std, and over every position before it where a verify row
    produced the token, max |verify row - plain row| / std(plain row)."""
    firsts, margins, diffs = [], [], []
    for p, a, b in zip(prompts, plain, spec):
        key = tuple(p)
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        firsts.append(i)
        if i is not None:
            row = plain_rows[(key, i)]
            top = np.partition(row, -2)[-2:]
            margins.append(float((top[1] - top[0]) / row.std()))
        for j in range(len(a) if i is None else i):
            v = verify_rows.get((key, j))
            if v is not None:
                row = plain_rows[(key, j)]
                diffs.append(float(np.abs(v - row).max() / row.std()))
    return firsts, margins, diffs


class ReplayDrafter:
    """A drafter of this script, not of the package: it proposes the plain
    run's own next tokens (of the same pass, set by ``spec_passes``) with
    the last one changed, so a round whose sequence still follows the
    plain run accepts up to k - 1 tokens and rejects the last — a partial
    acceptance every round, which rolls dense state back.  It drafts
    whatever the model's output looks like, where the n-gram drafter needs
    the output to repeat itself (random mamba2-780m weights never do on
    this workload)."""

    name = "replay"

    def __init__(self, tables, vocab):
        self.tables = tables        # pass -> prompt tuple -> plain tokens
        self.plain = tables["cold"]
        self.vocab = vocab

    def propose(self, request, k):
        i = len(request.output_tokens)
        toks = list(self.plain[tuple(request.prompt)][i:i + k])
        if toks:
            toks[-1] = (toks[-1] + 1) % self.vocab
        return toks

    def rollback(self, request):
        pass

    def release(self, request_id):
        pass


def set_drafter(eng, drafter):
    """Give ``eng`` a fresh SpecDecoder with ``drafter`` (None: the
    configured one), its verify rows checked as ``checking_engine``
    checks them."""
    from repro_torch.serve.spec import SpecDecoder
    eng.spec = SpecDecoder(eng, eng.engine_cfg.speculation, drafter=drafter)
    check_verify_rows(eng.spec)


def phase_speculation(arch, params, dtype=torch.bfloat16,
                      drafters=("ngram", "replay")):
    """Speculative decoding (k = 4) at full width on the main path's
    engine setting and weights (bf16; in fp32 the same weights widened):
    eight repetitive prompts of the smoke's lengths, 32 greedy tokens
    each, served cold, warm, and warm again with every committed row
    recorded, on a plain engine and then on a speculative one per drafter:
    the package's n-gram drafter, and ``ReplayDrafter`` (every round a
    partial acceptance).  Each speculative run is checked by
    ``speculation_run``; one of the runs must have verified drafts.
    Returns the kernels' launches over the runs' passes."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import SamplingParams
    from repro_torch.serve.spec import SpeculationConfig
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    ec = smoke_ec()
    prompts = spec_prompts(cfg.vocab_size)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    plain = checking_engine()(cfg, params=params, engine_cfg=ec)
    base = spec_passes(plain, prompts, sampling, "graphs")
    del plain
    torch.cuda.empty_cache()
    tables = {label: dict(zip(map(tuple, prompts), base[1][label][0]))
              for label in ("cold", "warm")}
    spec_ec = dataclasses.replace(
        ec, speculation=SpeculationConfig("ngram", k=SPEC_K))
    launches, verified = {}, 0
    for kind in drafters:
        drafter = ReplayDrafter(tables, cfg.vocab_size) \
            if kind == "replay" else None
        got, n_verify = speculation_run(cfg, params, spec_ec, drafter,
                                        prompts, sampling, base)
        verified += n_verify
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    check(verified > 0, f"{arch}: no drafter's tokens were verified")
    return launches


def speculation_run(cfg, params, ec, drafter, prompts, sampling, base):
    """One drafter's speculative engine: the kernels' counts are set to 0
    just before its passes and read just after.  Gates: every request
    ends ``"length"`` with its 32 tokens; no logits row, verify rows
    included, is non-finite; proposed = accepted + rejected; launches =
    decode + prefill + verify; no page or dense slot left held; one graph
    per step that ran; paged attention on every attention layer of every
    launch and the fused SSD scan on every mamba layer of every chunk and
    verify launch, the plain versions at 0; for a dense model at least one
    restore per rollback; greedy tokens equal to the plain engine's,
    except that a request may leave them at a position where the plain
    run's top-2 margin is below SPEC_MARGIN of its row's std — or, if
    verify and plain rows at agreeing positions differ by more than that,
    below twice the largest such difference (a row perturbation of d
    moves the top-2 gap by at most 2d).  A run that verified drafts must
    hold ``verify_bs{N}_len5`` graphs, and ``ReplayDrafter`` must draft.
    Then the same passes on the eager queue, the verify-step profile, and
    for a dense model the snapshot and restore times.  Returns (launches,
    verify launches)."""
    name = "ngram" if drafter is None else drafter.name
    eng = checking_engine()(cfg, params=params, engine_cfg=ec)
    if drafter is not None:
        set_drafter(eng, drafter)
    counters = kernel_counters()
    for kern, plain_fn in counters.values():    # every count to 0 ...
        kern.launches = plain_fn.launches = 0
    restores0 = eng.store.n_restores
    passes, outputs, recs = spec_passes(eng, prompts, sampling, "graphs")
    launches = {k: kern.launches for k, (kern, _) in counters.items()}
    plain_runs = {k: p.launches for k, (_, p) in counters.items()}  # read
    restores = eng.store.n_restores - restores0

    tot = {k: sum(o[1][k] for o in outputs.values()) for k in (
        "decode_launches", "prefill_launches", "spec_launches",
        "prefill_chunk_launches", "spec_proposed_tokens",
        "spec_accepted_tokens", "spec_rejected_tokens", "spec_rollbacks")}
    n_launches = tot["decode_launches"] + tot["prefill_launches"] \
        + tot["spec_launches"]
    arch = f"{cfg.name} ({name})"
    check(drafter is None or tot["spec_launches"] > 0,
          f"{arch}: the replay drafter's rounds never ran")
    for label, (_, st) in outputs.items():
        check(st["spec_proposed_tokens"] == st["spec_accepted_tokens"]
              + st["spec_rejected_tokens"],
              f"{arch} {label}: proposed != accepted + rejected")
    check(eng.pool.n_free == eng.pool.n_blocks,
          f"{arch}: {eng.pool.n_blocks - eng.pool.n_free} pages still held")
    check(eng.store.slot_pool is None or eng.store.slot_pool.n_used == 0,
          f"{arch}: dense slots still held")
    graphs = check_graphs(eng)
    verify = sorted(n for n in eng.kernel_events()
                    if n.startswith("verify_bs"))
    check(bool(verify) == (tot["spec_launches"] > 0) and all(
        n.endswith(f"_len{SPEC_K + 1}") for n in verify),
        f"{arch}: verify steps {verify}")
    mixers = [m for m, _ in cfg.pattern()]
    # kernel.py::plan: bf16 (state 128) at one chunk takes the fused scan,
    # fp32 the two passes on the CUDA cores
    fused = cfg.compute_dtype == torch.bfloat16
    scans = mixers.count("mamba") * (tot["prefill_chunk_launches"]
                                     + tot["spec_launches"])
    per_group = {"paged_attention": mixers.count("attn") * n_launches,
                 "ssd_chunk": 0 if fused else scans,
                 "ssd_apply": 0 if fused else scans,
                 "ssd_scan_fused": scans if fused else 0,
                 "grouped_mm": [f for _, f in cfg.pattern()].count("moe")
                 * n_launches}
    per_group["grouped_mm_swiglu"] = per_group["grouped_mm"]
    for k, n in per_group.items():
        check(launches[k] == cfg.n_groups() * n,
              f"{arch}: {k} launches {launches[k]} != {cfg.n_groups() * n}")
        check(plain_runs[k] == 0,
              f"{arch}: the plain {k} ran {plain_runs[k]} times")
    if eng.store.has_dense:
        check(restores >= tot["spec_rollbacks"],
              f"{arch}: {restores} restores < {tot['spec_rollbacks']} "
              f"rollbacks")

    base_passes, base_out, base_recs = base
    compared = {label: greedy_against_plain(
        prompts, base_out[label][0], outputs[label][0], base_recs[label],
        recs[label]) for label in ("cold", "warm")}
    diffs = [d for _, _, ds in compared.values() for d in ds]
    d_max = max(diffs) if diffs else 0.0
    bound = SPEC_MARGIN if 2 * d_max <= SPEC_MARGIN else 2 * d_max
    for label, (firsts, margins, _) in compared.items():
        for m in margins:
            check(m < bound, f"{arch} {label}: speculative tokens leave the "
                  f"plain ones where the plain top-2 margin is {m:.4f} of "
                  f"the row std (bound {bound:.4f}): {firsts}")
    ev = eng.kernel_events()
    emit("speculation", config=cfg.name, drafter=name, k=SPEC_K,
         dtype=dname(cfg.compute_dtype),
         kernel_launches=launches, plain_launches=plain_runs,
         engine_launches=n_launches, restores=restores, **tot,
         accept_rate=tot["spec_accepted_tokens"]
         / max(tot["spec_proposed_tokens"], 1),
         identical_requests={k: sum(i is None for i in v[0])
                             for k, v in compared.items()},
         first_divergence={k: v[0] for k, v in compared.items()},
         divergence_margins={k: v[1] for k, v in compared.items()},
         verify_vs_plain_row_diff=dict(
             n=len(diffs), max=d_max,
             p50=float(np.percentile(diffs, 50)) if diffs else None,
             p90=float(np.percentile(diffs, 90)) if diffs else None,
             p99=float(np.percentile(diffs, 99)) if diffs else None),
         margin_bound=bound,
         tokens_per_launch={
             "spec": {k: p["tokens_per_launch"] for k, p in passes.items()},
             "plain": {k: p["tokens_per_launch"]
                       for k, p in base_passes.items()}},
         warm_tokens_per_s={
             "spec": passes["warm"]["tokens_per_s_runs"],
             "plain": base_passes["warm"]["tokens_per_s_runs"]},
         warm_mean_ttft_ms={
             "spec": passes["warm"]["mean_ttft_ms_runs"],
             "plain": base_passes["warm"]["mean_ttft_ms_runs"]},
         verify_build_s={n: ev[n].build_time_s for n in verify},
         graphs=graphs)
    phase_graphs_spec(eng, drafter, prompts, sampling, outputs)
    if any(n.startswith("verify_bs8_") for n in verify):
        phase_verify_profile(eng, name, prompts, sampling)
    if eng.store.has_dense and drafter is not None:
        emit("snapshot_restore", config=cfg.name,
             dtype=dname(cfg.compute_dtype), **snapshot_restore_ms(eng))
    del eng
    torch.cuda.empty_cache()
    return launches, tot["spec_launches"]


def snapshot_restore_ms(eng, reps=5):
    """Wall time of a verify round's dense snapshot of 8 slots (one gather
    per dense leaf) and of restoring all 8 (the worst round), host clock
    around each with a synchronize, least and mean of ``reps``; and the
    bytes snapshotted.  Runs on the free slots after the passes."""
    store = eng.store
    slots = list(range(8))
    snap_ms, restore_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snaps = store.snapshot_slots(slots)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for slot, snap in zip(slots, snaps):
            store.restore_slot(slot, snap)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        snap_ms.append((t1 - t0) * 1e3)
        restore_ms.append((t2 - t1) * 1e3)
    return dict(slots=len(slots), bytes=len(slots) * store.dense_slot_bytes,
                snapshot_ms_min=min(snap_ms),
                snapshot_ms_mean=float(np.mean(snap_ms)),
                restore_all_ms_min=min(restore_ms),
                restore_all_ms_mean=float(np.mean(restore_ms)))


def phase_graphs_spec(eng, drafter, prompts, sampling, outputs):
    """The same speculative passes on a queue that runs every step body
    eagerly, the verify steps included: each pass's greedy tokens and
    ``EngineStats`` must equal the replaying engine's."""
    eager = eager_engine()(eng.cfg, params=eng.params,
                           engine_cfg=eng.engine_cfg)
    if drafter is not None:
        set_drafter(eager, drafter)
    passes, got, _ = spec_passes(eager, prompts, sampling, "eager")
    for label in ("cold",) + WARM_TIMED + ("warm_rec",):
        check(got[label][0] == outputs[label][0],
              f"{eng.cfg.name} speculation {label}: replayed tokens differ "
              f"from eager ones")
        check(got[label][1] == outputs[label][1],
              f"{eng.cfg.name} speculation {label}: EngineStats differ: "
              f"graphs {outputs[label][1]} eager {got[label][1]}")
    emit("graphs_speculation", config=eng.cfg.name,
         drafter=eng.spec.drafter.name, tokens_match=True, stats_match=True,
         eager_warm=passes["warm"])
    del eager
    torch.cuda.empty_cache()


def verify_steps(eng, prompts, sampling, measure, n_keep=3, max_steps=60):
    """Serve ``prompts`` again and call ``measure(step)`` around each step
    after the first tokens until ``n_keep`` steps were batch-8 verify
    launches; ``measure`` returns that step's row.  Returns the rows of
    the verify steps."""
    name = f"verify_bs8_len{SPEC_K + 1}"
    reqs = [eng.submit(p, sampling) for p in prompts]
    while not all(r.output_tokens for r in reqs):
        eng.step()
    built = eng.queue.n_executables
    ev = eng.kernel_events()[name]
    rows = []
    for _ in range(max_steps):
        if len(rows) == n_keep or not eng.scheduler.has_work:
            break
        n0 = ev.launches
        torch.cuda.synchronize()
        row = measure(eng.step)
        if ev.launches == n0 + 1:
            rows.append(row)
    check(eng.queue.n_executables == built,
          "a step was built inside the measured window")
    eng.drain()
    check(len(rows) == n_keep, f"{len(rows)} {name} steps in {max_steps}")
    return rows


def phase_verify_profile(eng, drafter, prompts, sampling):
    """Where a replayed batch-8 verify step's time goes.  First without
    the profiler: the step's host wall split into the round's phases
    (``prepare``: drafting, page ensures and the dense snapshot;
    ``launch``: operand fill, graph replay, logits rows to the host and
    the wait; ``commit``: accept/reject, bookkeeping and restores) and the
    rest (scheduling, ``finish``).  Then each step under its own
    torch.profiler window: wall, device busy time, idle share and top
    kernels.  The host checks of the rows are off (the passes made
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec, parts = eng.spec, {}
    eng.checking = False

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run
    saved = {key: getattr(spec, key) for key in ("prepare", "launch",
                                                "commit")}
    for key, fn in saved.items():
        setattr(spec, key, timed(fn, key))

    def split(step):
        parts.clear()
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0
        row = {f"{k}_ms": v * 1e3 for k, v in parts.items()}
        row["rest_ms"] = (wall - sum(parts.values())) * 1e3
        row["step_wall_ms"] = wall * 1e3
        return row
    host = verify_steps(eng, prompts, sampling, split)
    for key, fn in saved.items():
        setattr(spec, key, fn)

    def profiled(step):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
        return dict(
            step_wall_ms=wall_ms,
            device_busy_ms=busy if kern else "not measured",
            device_idle_share=1 - busy / wall_ms if kern
            else "not measured",
            kernels=sum(e.count for e in kern),
            top=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                  "calls": e.count} for e in top])
    rows = verify_steps(eng, prompts, sampling, profiled)
    emit("verify_profile", config=eng.cfg.name, drafter=drafter,
         step=f"verify_bs8_len{SPEC_K + 1}", host=host, steps=rows)
    return rows


def kernel_shares(kern, busy_ms, shares, per=1):
    """label -> (ms, launches, share of the busy time) of the profiled
    kernels whose names contain one of ``shares[label]``, per step."""
    out = {}
    for label, names in shares.items():
        rows = [e for e in kern if any(n in e.key for n in names)]
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / per
        out[label] = dict(ms=ms, launches=sum(e.count for e in rows) / per,
                          share=ms / busy_ms if busy_ms else "not measured")
    return out


def phase_profile(eng, prompts, sampling, n_steps=8, shares=None):
    """Where a batch-8 decode step's time goes: ``n_steps`` steps under
    torch.profiler after the prompts are in.  Device busy time is the sum
    of the kernels' own times; the rest of the host wall is device idle.
    ``shares``: label -> kernel names whose part of it is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.submit(p, sampling) for p in prompts]
    while not all(r.output_tokens for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    built = eng.queue.n_executables
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    check(eng.queue.n_executables == built,
          "a step was built inside the profiled window")
    eng.drain()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n_steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    row = dict(
        config=eng.cfg.name, steps=n_steps, batch=len(prompts),
        step_wall_ms=wall_ms,
        device_busy_ms=busy_ms if kern else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if kern else "not measured",
        kernels_per_step=sum(e.count for e in kern) / n_steps,
        kernel_shares=kernel_shares(kern, busy_ms, shares or {}, n_steps)
        if kern else "not measured",
        top=[{"name": e.key[:80], "ms_per_step":
              e.self_device_time_total / 1e3 / n_steps,
              "calls_per_step": e.count / n_steps} for e in top])
    emit("profile", **row)
    return row


def phase_prefill_profile(eng, shares=None, prompt_len=300, batch=8):
    """Where a batch-8 len256 chunked-prefill step's time goes: ``batch``
    fresh prompts of ``prompt_len`` tokens arrive at once, so the first
    step feeds every slot 256 tokens; that one step runs under
    torch.profiler.  Device busy time is the sum of the kernels' own
    times; ``shares`` (label -> kernel names; by default ``ssd``, every
    SSD kernel; qwen3-moe's grouped GEMM) names the parts reported of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import SamplingParams
    rng = np.random.default_rng(7)
    reqs = [eng.submit(rng.integers(0, eng.cfg.vocab_size,
                                    prompt_len).tolist(),
                       SamplingParams(max_tokens=1)) for _ in range(batch)]
    n0 = eng.stats.prefill_chunk_launches
    torch.cuda.synchronize()
    built = eng.queue.n_executables
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    step = max(eng.kernel_events().items(),
               key=lambda kv: kv[1].last_enqueue_t)[0]
    check(eng.stats.prefill_chunk_launches == n0 + 1
          and step == f"prefill_bs{batch}_len256",
          f"the profiled step was {step}, not prefill_bs{batch}_len256")
    check(eng.queue.n_executables == built,
          "the profiled step was built inside the profiled window")
    eng.drain()
    check(all(r.output_tokens for r in reqs), "a profiled prompt got no token")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    row = dict(
        config=eng.cfg.name, step=step,
        step_wall_ms=wall_ms,
        device_busy_ms=busy_ms if kern else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if kern
        else "not measured",
        kernels=sum(e.count for e in kern),
        kernel_shares=kernel_shares(kern, busy_ms, shares or {"ssd": [
            n for ns in SSD_KERNELS.values() for n in ns]})
        if kern else "not measured",
        top=[{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
              "calls": e.count} for e in top])
    emit("prefill_profile", **row)
    return row


# ---------------------------------------------------------------------------
# The service front-end and the resilience layer at full width.
# ---------------------------------------------------------------------------

# tests/test_chaos.py's soak: the launch, device, nan, pool and stall sites
SOAK_RATES = {"launch": 0.10, "device": 0.08, "nan_logits": 0.04,
              "pool": 0.08, "stall": 0.03}


def replays(engines):
    """(step launches, of which chunk and verify launches) that the
    engines' queues made since they were built, each a graph replay."""
    total = chunks = 0
    for eng in engines:
        for name, ev in eng.kernel_events().items():
            total += ev.launches
            chunks += 0 if name.startswith("serve_step") else ev.launches
    return total, chunks


def gate_path_launches(label, counters, groups):
    """The kernels' counts over a driven path against its engines' step
    replays (``groups``: (config, engines) pairs): an attention layer
    launches paged attention on every replay, a mamba layer the fused scan
    (bf16) or the two simt passes (fp32) on every chunk and verify replay,
    and no plain version runs.  Returns the launches by kernel."""
    want = dict.fromkeys(counters, 0)
    for cfg, engines in groups:
        total, chunks = replays(engines)
        mixers = [m for m, _ in cfg.pattern()]
        want["paged_attention"] += cfg.n_groups() * mixers.count("attn") \
            * total
        scans = cfg.n_groups() * mixers.count("mamba") * chunks
        for k in (("ssd_scan_fused",) if cfg.compute_dtype == torch.bfloat16
                  else ("ssd_chunk", "ssd_apply")):
            want[k] += scans
    got = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: p.launches for k, (_, p) in counters.items()}
    check(got == want, f"{label}: kernel launches {got} != {want}")
    check(not any(plain.values()), f"{label}: plain versions ran {plain}")
    return got


def hold_tokens(label, prompts, want, got, want_rows=None, got_rows=None):
    """Hold each request's tokens ``got`` (None: quarantined, not held)
    against the reference ``want``.  Without rows they must be identical;
    with the committed rows of both runs, a request may leave the
    reference only where the reference row's top-2 margin is under
    phase_speculation's bound (SPEC_MARGIN of the row std, or twice the
    largest row difference at agreeing positions where that is larger):
    the two runs batch the request differently, and bf16 rounds the
    batch's products differently.  Returns the comparison."""
    keep = [i for i, g in enumerate(got) if g is not None]
    if want_rows is None:
        bad = [i for i in keep if got[i] != want[i]]
        check(not bad, f"{label}: requests {bad} left the reference tokens")
        return dict(requests=len(keep), identical=len(keep))
    firsts, margins, diffs = greedy_against_plain(
        [prompts[i] for i in keep], [want[i] for i in keep],
        [got[i] for i in keep], want_rows, got_rows)
    d_max = max(diffs) if diffs else 0.0
    bound = SPEC_MARGIN if 2 * d_max <= SPEC_MARGIN else 2 * d_max
    for m in margins:
        check(m < bound, f"{label}: tokens leave the reference where its "
              f"top-2 margin is {m:.4f} of the row std (bound {bound:.4f})"
              f": {firsts}")
    return dict(requests=len(keep),
                identical=sum(f is None for f in firsts),
                first_divergence=firsts, divergence_margins=margins,
                row_diff_max=d_max, margin_bound=bound)


def serve_once(eng, prompts, sampling, record=False):
    """``generate()`` on fresh ``EngineStats``: (completions, the stats,
    the host wall in s, the committed rows when ``record``)."""
    from repro_torch.serve.engine import EngineStats, generate
    eng.stats = EngineStats()
    rec, unwrap = record_rows(eng) if record else ({}, lambda: None)
    t0 = time.perf_counter()
    outs = generate(eng, prompts, sampling)
    wall = time.perf_counter() - t0
    unwrap()
    return outs, dataclasses.asdict(eng.stats), wall, rec


def drained(eng):
    return eng.pool.n_free == eng.pool.n_blocks and (
        eng.store.slot_pool is None or eng.store.slot_pool.n_used == 0)


def mixed_prompts(seed, vocab, copies=1):
    """The smoke's mixed lengths (``copies`` times), tokens from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist()
            for n in PROMPT_LENS * copies]


def service_pass(eng, prompts, rate, admission, seed, ttft_slo=None):
    """One open-loop pass of the service over ``eng``: a client per prompt,
    arriving at Poisson gaps of mean 1 / ``rate`` from ``default_rng(seed)``,
    each streaming ``MAX_TOKENS`` greedy tokens.  Returns ((tokens,
    completion) per client, the metrics snapshot, the pass's wall in s)."""
    import asyncio

    from repro_torch.serve.engine import EngineStats
    from repro_torch.serve.service import GenerateService, ServiceConfig
    gaps = np.random.default_rng(seed).exponential(1.0 / rate,
                                                   size=len(prompts))
    eng.stats = EngineStats()

    async def client(svc, prompt):
        stream = await svc.submit(prompt, max_tokens=MAX_TOKENS,
                                  ttft_deadline_s=ttft_slo)
        return await stream.drain()

    async def drive():
        async with GenerateService(
                eng, ServiceConfig(admission=admission)) as svc:
            t0 = time.perf_counter()
            tasks = []
            for prompt, gap in zip(prompts, gaps):
                await asyncio.sleep(gap)    # open loop: Poisson arrivals
                tasks.append(asyncio.create_task(client(svc, prompt)))
            out = await asyncio.gather(*tasks)
            return out, svc.metrics.snapshot(), time.perf_counter() - t0

    return asyncio.run(drive())


def service_row(eng, label, out, snap, wall, rate):
    """Gate one service pass (shed streams end "shed" with no token, the
    rest "length" with their tokens; no page or slot left held) and emit
    its numbers."""
    for toks, comp in out:
        if comp.finish_reason == "shed":
            check(toks == [], f"service {label}: a shed stream has tokens")
        else:
            check(comp.finish_reason == "length" and len(toks) == MAX_TOKENS,
                  f"service {label}: {comp.request_id} ended "
                  f"{comp.finish_reason} after {len(toks)} tokens")
    check(drained(eng), f"service {label}: pages or slots left held")
    row = dict(pass_=label, rate_req_s=rate, requests=len(out),
               completed=snap["completed"], shed=snap["shed"],
               rejected=snap["rejected"],
               ttft_p50_ms=1e3 * (snap["ttft_s"]["p50"] or 0.0),
               ttft_p99_ms=1e3 * (snap["ttft_s"]["p99"] or 0.0),
               ttft_mean_ms=1e3 * (snap["ttft_s"]["mean"] or 0.0),
               itl_mean_ms=1e3 * (snap["itl_s"]["mean"] or 0.0),
               tokens=snap["tokens"], wall_s=wall,
               tokens_per_s=snap["tokens"] / wall,
               launches=eng.stats.launches)
    emit("service_pass", config=eng.cfg.name, **row)
    return row


def phase_service(params):
    """The asyncio service over qwen2-0.5b at full width (bf16, the
    smoke's engine setting), the kernels' counts set to 0 just before and
    read just after.  A reference engine serves the mixed lengths four
    times over (32 requests) through ``generate()``: once to build its
    graphs, once recording every committed row (the reference tokens),
    once timed, which gives the warm request rate R.  Then a cold service
    on a fresh engine, every graph captured on the service's engine thread:
    32 clients at Poisson arrivals of 0.5 R, fifo; each stream's tokens
    must be the reference's (``hold_tokens``) and end "length" with 32.
    Then, warm, 32 fresh requests at 0.5 R, and 64 at 2 R with fifo and
    with ``deadline`` admission at a TTFT SLO of 4 x the warm 0.5 R pass's
    mean TTFT.  Returns the kernels' launches."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import SamplingParams
    cfg = get_config("qwen2-0.5b")
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    reserved = torch.cuda.memory_reserved()
    counters = zero_counts()
    ref = checking_engine()(cfg, params=params, engine_cfg=smoke_ec())
    serve_once(ref, mixed_prompts(11, cfg.vocab_size, 4), sampling)
    prompts = mixed_prompts(12, cfg.vocab_size, 4)
    want, _, _, want_rows = serve_once(ref, prompts, sampling, record=True)
    ref.checking = False
    timed, _, wall, _ = serve_once(ref, mixed_prompts(13, cfg.vocab_size, 4),
                                   sampling)
    rate = len(timed) / wall
    emit("service_rate", config=cfg.name, requests=len(timed), wall_s=wall,
         rate_req_s=rate, launches=ref.stats.launches)

    eng = checking_engine()(cfg, params=params, engine_cfg=smoke_ec())
    threads = []
    build = eng.queue.build

    def build_on(*args, **kw):
        threads.append(threading.current_thread().name)
        return build(*args, **kw)
    eng.queue.build = build_on
    rec, unwrap = record_rows(eng)
    out, snap, wall = service_pass(eng, prompts, 0.5 * rate, "fifo", 0)
    unwrap()
    cold = service_row(eng, "cold fifo 0.5R", out, snap, wall, 0.5 * rate)
    check(cold["shed"] == 0 and cold["completed"] == len(prompts),
          f"cold service: {cold}")
    held = hold_tokens("cold service", prompts, [c.tokens for c in want],
                       [t for t, _ in out], want_rows, rec)
    graphs = check_graphs(eng)
    check(threads and set(threads) == {"engine-loop"},
          f"cold service: graphs built on threads {sorted(set(threads))}")
    del eng.queue.build

    eng.checking = False
    # the cold pass's TTFT is set by its graph captures, which queue the
    # first arrivals behind each other: the SLO is taken from the same
    # pass warm
    quiet = service_row(eng, "warm fifo 0.5R", *service_pass(
        eng, mixed_prompts(16, cfg.vocab_size, 4), 0.5 * rate, "fifo", 16),
        0.5 * rate)
    slo = 4 * quiet["ttft_mean_ms"] / 1e3
    warm = [quiet] + [service_row(eng, label, *service_pass(
        eng, mixed_prompts(seed, cfg.vocab_size, 8), 2 * rate, admission,
        seed, ttft_slo), 2 * rate)
        for label, admission, seed, ttft_slo in (
            ("warm fifo 2R", "fifo", 14, None),
            ("warm deadline 2R", "deadline", 15, slo))]
    launches = gate_path_launches("qwen2-0.5b service", counters,
                                  [(cfg, [ref, eng])])
    emit("service", config=cfg.name, reserved_at_start=reserved,
         rate_req_s=rate, ttft_slo_s=slo,
         cold_vs_generate=held, graphs=graphs, graph_threads=len(threads),
         passes=[cold] + warm, kernel_launches=launches)
    del ref, eng
    gc.collect()                # the checking wrappers make cycles
    torch.cuda.empty_cache()
    return launches


def step_until(eng, reqs, n_tokens):
    """Step ``eng`` until every request of ``reqs`` holds ``n_tokens``
    tokens; none may finish on the way."""
    while min(len(r.output_tokens) for r in reqs) < n_tokens:
        check(eng.step(), "the engine went idle before the cut")
    check(not any(r.is_finished for r in reqs), "a request finished early")


def drain_restore(src, dst, prompts, sampling, path, n_tokens=8):
    """Submit ``prompts`` to ``src``, cut at ``n_tokens`` tokens each,
    ``drain_to`` and ``restore_from`` on ``dst``, drained.  Returns the
    restored outputs in prompt order."""
    reqs = [src.submit(p, sampling) for p in prompts]
    step_until(src, reqs, n_tokens)
    check(src.drain_to(path) == len(prompts), "not every request drained")
    check(drained(src), "drain_to left pages or slots held")
    restored = dst.restore_from(path)
    dst.drain()
    by_prompt = {tuple(r.prompt): r for r in restored}
    for r in restored:
        check(r.finish_reason == "length", f"restored {r.request_id}: "
              f"{r.finish_reason}")
    return [by_prompt[tuple(p)].output_tokens for p in prompts]


def phase_resilience(arch, params):
    """The resilience layer at full width (bf16, the smoke's engine
    setting, the mixed lengths, 32 greedy tokens), the kernels' counts set
    to 0 just before and read just after.  An unguarded engine serves the
    reference (rows recorded).  An armed guard with no fault
    (``ResilienceConfig()``) must give its tokens and ``EngineStats``
    exactly; then both serve warm in turns (unguarded, guarded, guarded,
    unguarded), unchecked, for the step wall with and without the guard's
    pre-step dense snapshot.  Under tests/test_chaos.py's seeded soak
    (launch, device, nan, pool and stall sites) the guarded engine must
    give every request that is not quarantined the reference tokens
    (``hold_tokens``), drain its pools and count every replay (launches +
    device faults).  Then the guarded engine is drained mid-generation
    (``drain_to``) and restored on a fresh one, which must continue to
    the reference (the near-tie rule: the restored run ingests the
    generated tokens on the chunk path), and ``drain_fp32`` holds both
    drains to the exact tokens.  Returns the kernels' launches."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import SamplingParams
    from repro_torch.serve.resilience import FaultInjector, ResilienceConfig
    cfg = get_config(arch)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    prompts = mixed_prompts(0, cfg.vocab_size)
    Engine = checking_engine()
    reserved = torch.cuda.memory_reserved()
    counters = zero_counts()
    plain = Engine(cfg, params=params, engine_cfg=smoke_ec())
    want, want_stats, _, want_rows = serve_once(plain, prompts, sampling,
                                                record=True)
    want_tokens = [c.tokens for c in want]
    quiet = Engine(cfg, params=params, engine_cfg=smoke_ec(
        resilience=ResilienceConfig()))
    got, got_stats, _, _ = serve_once(quiet, prompts, sampling)
    hold_tokens(f"{arch} quiet guard", prompts, want_tokens,
                [c.tokens for c in got])
    check(got_stats == want_stats, f"{arch} quiet guard: EngineStats "
          f"{got_stats} != unguarded {want_stats}")
    walls = {"unguarded": [], "guarded": []}
    warm_tokens = []
    for eng, key in ((plain, "unguarded"), (quiet, "guarded"),
                     (quiet, "guarded"), (plain, "unguarded")):
        eng.checking = False
        outs, st, wall, _ = serve_once(eng, prompts, sampling)
        eng.checking = True
        warm_tokens.append([c.tokens for c in outs])
        walls[key].append(1e3 * wall / (st["decode_launches"]
                                        + st["prefill_launches"]))
    check(all(t == warm_tokens[0] for t in warm_tokens),
          f"{arch}: guarded and unguarded warm passes gave other tokens")

    inj = FaultInjector(1234, SOAK_RATES, stall_s=0.001, max_faults=60)
    chaos = Engine(cfg, params=params, engine_cfg=smoke_ec(
        fault_injector=inj, resilience=ResilienceConfig(
            max_request_failures=2)))
    got, st, wall, chaos_rows = serve_once(chaos, prompts, sampling,
                                           record=True)
    for c in got:
        check(c.finish_reason in ("length", "error"),
              f"{arch} chaos: {c.request_id} ended {c.finish_reason}")
    held = hold_tokens(f"{arch} chaos", prompts, want_tokens,
                       [None if c.finish_reason == "error" else c.tokens
                        for c in got], want_rows, chaos_rows)
    check(drained(chaos), f"{arch} chaos: pages or slots left held")
    fired = inj.counts()
    check(inj.n_fired > 0, f"{arch} chaos: no fault fired")
    engine_launches = st["decode_launches"] + st["prefill_launches"] \
        + st["spec_launches"]
    check(engine_launches + fired["device"] == replays([chaos])[0],
          f"{arch} chaos: {engine_launches} launches + {fired['device']} "
          f"device faults != {replays([chaos])[0]} replays")

    fresh = Engine(cfg, params=params, engine_cfg=smoke_ec())
    recorded = [record_rows(e) for e in (quiet, fresh)]
    with tempfile.TemporaryDirectory() as d:
        restored = drain_restore(quiet, fresh, prompts, sampling,
                                 f"{d}/drain.ckpt")
    rows = {}
    for rec, unwrap in recorded:
        rows.update(rec)
        unwrap()
    drain = hold_tokens(f"{arch} drain/restore", prompts, want_tokens,
                        restored, want_rows, rows)
    cfg32, engines, fp32 = drain_fp32(arch, params, prompts, sampling)
    groups = [(cfg, [plain, quiet, chaos, fresh]), (cfg32, engines)]
    launches = gate_path_launches(f"{arch} resilience", counters, groups)
    emit("resilience", config=cfg.name, reserved_at_start=reserved,
         faults=fired,
         fault_counters={k: v for k, v in st.items()
                         if k.startswith("fault_")},
         chaos=dict(held, quarantined=[c.request_id for c in got
                                       if c.finish_reason == "error"],
                    launches=engine_launches, wall_s=wall),
         guard_step_wall_ms=walls,
         guard_step_wall_median_ms={k: float(np.median(v))
                                    for k, v in walls.items()},
         drain_restore=drain, fp32=fp32, kernel_launches=launches)
    del plain, quiet, chaos, fresh, engines, groups
    gc.collect()                # the checking wrappers make cycles
    torch.cuda.empty_cache()
    return launches


def drain_fp32(arch, params, prompts, sampling):
    """The model in fp32 (the same weights widened), where the chunk and
    the decode paths give the same tokens: a drain mid-generation restored
    on a fresh engine, and a drain while a verify round is in flight (the
    script's ``ReplayDrafter``, which drafts on any weights: the n-gram
    drafter drafts nothing on random mamba2 weights), restored on a fresh
    speculative engine.  Each must give the uninterrupted run's tokens
    exactly (tests/test_speculative.py:394).  Returns (the config, its
    engines, the results)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.serve.resilience.checkpoint import load_checkpoint
    from repro_torch.serve.spec import SpeculationConfig
    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    p32 = to_dtype(params, torch.float32)
    Engine = checking_engine()
    plain = Engine(cfg, params=p32, engine_cfg=smoke_ec())
    want = [c.tokens for c in serve_once(plain, prompts, sampling)[0]]
    fresh = Engine(cfg, params=p32, engine_cfg=smoke_ec())
    spec_ec = smoke_ec(speculation=SpeculationConfig("ngram", k=SPEC_K))
    table = {"cold": dict(zip(map(tuple, prompts), want))}
    src, dst = (Engine(cfg, params=p32, engine_cfg=spec_ec)
                for _ in range(2))
    for e in (src, dst):
        set_drafter(e, ReplayDrafter(table, cfg.vocab_size))
    with tempfile.TemporaryDirectory() as d:
        got = drain_restore(plain, fresh, prompts, sampling, f"{d}/a.ckpt")
        hold_tokens(f"{arch} fp32 drain/restore", prompts, want, got)
        reqs = [src.submit(p, sampling) for p in prompts]
        step_until(src, reqs, 4)
        # past a rollback's re-feed: every slot samples its next step
        while not all(r.samples_this_step for r in reqs):
            check(src.step(), "the engine went idle before the cut")
        rnd = src.spec.prepare(src.scheduler.schedule())
        check(rnd is not None, "the replay drafter drafted nothing")
        src.spec.launch(rnd)
        src.queue.finish()
        committed = {tuple(r.prompt): list(r.output_tokens) for r in reqs}
        restores = src.store.n_restores
        path = f"{d}/b.ckpt"
        check(src.drain_to(path) == len(prompts), "not every request drained")
        check(src.spec._round is None and drained(src) and (
            not src.store.has_dense or src.store.n_restores > restores),
            "drain_to left the verify round in flight")
        saved = {tuple(rec["prompt"]): rec["output_tokens"]
                 for rec in load_checkpoint(path)["requests"]}
        check(saved == committed, "the checkpoint holds uncommitted tokens")
        restored = dst.restore_from(path)
        dst.drain()
    by_prompt = {tuple(r.prompt): r.output_tokens for r in restored}
    hold_tokens(f"{arch} fp32 drain mid-speculation", prompts, want,
                [by_prompt[tuple(p)] for p in prompts])
    result = dict(drain_restore_identical=len(prompts),
                  mid_speculation_identical=len(prompts),
                  restores_at_drain=src.store.n_restores - restores,
                  spec_launches=src.stats.spec_launches
                  + dst.stats.spec_launches)
    return cfg, [plain, fresh, src, dst], result


# ---------------------------------------------------------------------------
# The dense configs at full width, and the replica supervisor.
# ---------------------------------------------------------------------------

def phase_dense_wide():
    """qwen2-7b, then stablelm-12b (hd 160), at full width in bf16 with
    random weights from seed 0, through phase 6's engine setting and
    workload (cold, warm, one arrival per step) and its gates: every
    request ends "length" with 32 tokens, no logits row is non-finite,
    paged attention runs on every attention layer of every launch and its
    plain version never, one graph per step that ran.  Then eight replayed
    batch-8 decode steps of each under torch.profiler.  Returns the
    kernels' launches by arch."""
    out = {}
    for arch in DENSE_GEOMS:
        gc.collect()
        torch.cuda.empty_cache()
        counts, eng, prompts, arrivals, sampling, outputs, _ = \
            phase_engine(arch)
        phase_profile(eng, arrivals, sampling,
                      shares={"paged_attention": ("paged_",)})
        out[arch] = counts
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


class ArmedInjector:
    """A fault injector for the supervisor phase, defined here so that a
    spawned worker can unpickle it (the worker imports this script as its
    main module).  Its process_kill and checkpoint_corrupt sites fire once
    each, when the parent arms them by creating ``arm_path``: the next
    checkpoint the worker writes is corrupted (truncated), and the worker
    dies hard at its next step, so the restore must fall back to the
    previous good checkpoint.  Every other site is a FaultInjector that
    never fires."""

    def __init__(self, arm_path):
        from repro_torch.serve.resilience import FaultInjector
        self.inner = FaultInjector(0, {})
        self.arm_path = arm_path
        self.corrupted = False

    def __getattr__(self, name):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def corrupt_checkpoint(self):
        import os
        if self.corrupted or not os.path.exists(self.arm_path):
            return False
        self.corrupted = True
        self.inner._record("checkpoint_corrupt")
        return True

    def kill_process(self):
        import os
        if not (self.corrupted and os.path.exists(self.arm_path)):
            return False
        os.remove(self.arm_path)
        self.inner._record("process_kill")
        return True


def counting_supervisor():
    """ReplicaSupervisor that counts **replay divergences**: tokens a new
    incarnation replays below a stream's high-water mark (which the dedup
    drops) that differ from the tokens already delivered there."""
    from repro_torch.serve.supervisor import ReplicaSupervisor

    class Counting(ReplicaSupervisor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.replayed = 0
            self.divergences = []          # (request_id, index)

        def _handle_event(self, ev):
            if ev[0] == "tok":
                _, rid, start, toks = ev
                st = self._streams.get(rid)
                if st is not None:
                    for i, t in enumerate(toks):
                        if start + i < st.hwm:
                            self.replayed += 1
                            if st.delivered[start + i] != int(t):
                                self.divergences.append((rid, start + i))
            super()._handle_event(ev)
    return Counting


# the i-th failure of a supervised pass comes once SUP_AT[i] tokens are
# delivered (and the i-th worker is up)
SUP_AT = (48, 112, 176)
SUP_TIMEOUT_S = 600.0         # one supervised pass, worker starts included


def child_launch_gate(label, cfg, st):
    """One incarnation's own counts (a ``("stats",)`` snapshot): paged
    attention on every attention layer of every launch, the fused scan
    (bf16) or the two simt passes (fp32) on every mamba layer of every
    chunk launch, no plain version, no kernel built in the child.
    Returns the launches by kernel."""
    steps = st["step_launches"]
    total = sum(steps.values())
    chunks = sum(n for k, n in steps.items()
                 if not k.startswith("serve_step"))
    mixers = [m for m, _ in cfg.pattern()]
    want = dict.fromkeys(("paged_attention", "ssd_chunk", "ssd_apply",
                          "ssd_scan_fused"), 0)
    want["paged_attention"] = cfg.n_groups() * mixers.count("attn") * total
    scans = cfg.n_groups() * mixers.count("mamba") * chunks
    for k in (("ssd_scan_fused",) if cfg.compute_dtype == torch.bfloat16
              else ("ssd_chunk", "ssd_apply")):
        want[k] = scans
    kl = st["kernel_launches"]
    got = {k: kl.get(f"{k}_cuda", 0) for k in want}
    plain = {k: n for k, n in kl.items() if k.endswith("_ref") and n}
    check(got == want, f"{label}: child kernel launches {got} != {want}")
    check(not plain, f"{label}: plain versions ran in a child: {plain}")
    check(not any(st["kernel_builds"].values()),
          f"{label}: a child built a kernel: {st['kernel_builds']}")
    return got


def supervised_pass(arch, dtype, workdir, failures):
    """One supervised run of the mixed lengths (32 greedy tokens each) on
    ``arch`` at full width in ``dtype``, against an in-process
    ``spec.build()`` engine's uninterrupted run, which the parent drops
    before any worker spawns.  ``failures`` is the schedule, failure i at
    SUP_AT[i] delivered tokens: "kill" a ``kill_replica`` call, "inject"
    the ArmedInjector armed (the next checkpoint is corrupted, the worker
    dies at its next step).  Gates: every stream ends "length" with 32
    tokens and its completion equals what it streamed (zero duplicated,
    zero dropped), the last worker holds no page, slot or request (zero
    leaked), one failover a failure with the corrupted checkpoint seen
    where one was injected, no watchdog trip, each child's kernel counts
    (``child_launch_gate``); in fp32 the streams equal the uninterrupted
    tokens exactly and no replayed token diverges.  Returns the pass's
    record and the children's launches."""
    import asyncio
    import os

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import SamplingParams, generate
    from repro_torch.serve.supervisor import EngineSpec, SupervisorConfig
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                              compute_dtype=dtype)
    label = f"{arch} supervised {dname(dtype)}"
    prompts = mixed_prompts(0, cfg.vocab_size)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    clean = EngineSpec(cfg, smoke_ec(), seed=0)
    eng = clean.build()
    rec, unwrap = record_rows(eng)
    t0 = time.perf_counter()
    want = [c.tokens for c in generate(eng, prompts, sampling)]
    ref_s = time.perf_counter() - t0
    unwrap()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    arm = os.path.join(workdir, f"{arch}-{dname(dtype)}.arm")
    spec = EngineSpec(cfg, smoke_ec(fault_injector=ArmedInjector(arm)),
                      seed=0)
    sup_cfg = SupervisorConfig(
        checkpoint_path=os.path.join(workdir,
                                     f"{arch}-{dname(dtype)}.ckpt"),
        checkpoint_every_steps=4, fsync=True, max_respawns=3,
        # above one graph capture (0.1-0.3 s each; the first step of a
        # fresh incarnation captures, and has the amnesty besides)
        watchdog_timeout_s=5.0, ready_timeout_s=300.0)
    snaps, kills = [], []

    async def drive():
        Sup = counting_supervisor()
        async with Sup(spec, sup_cfg) as sup:
            streams = [await sup.submit(p, max_tokens=MAX_TOKENS)
                       for p in prompts]
            got = {s.request_id: [] for s in streams}
            comps = {}

            async def consume(s):
                async for tok in s:
                    got[s.request_id].append(tok)
                comps[s.request_id] = s.completion

            def delivered():
                return sum(len(v) for v in got.values())

            async def until(n_tokens, n_spawns):
                while delivered() < n_tokens or sup.n_spawns < n_spawns:
                    await asyncio.sleep(0.005)

            async def killer():
                for i, failure in enumerate(failures):
                    await until(SUP_AT[i], i + 1)
                    snaps.append(await sup.replica_stats())
                    if failure == "kill":
                        kills.append(("kill_replica", time.time(),
                                      delivered()))
                        await sup.kill_replica()
                    else:
                        kills.append(("injected", None, delivered()))
                        open(arm, "w").close()

            tasks = [asyncio.create_task(consume(s)) for s in streams]
            await asyncio.wait_for(asyncio.gather(killer(), *tasks),
                                   SUP_TIMEOUT_S)
            snaps.append(await sup.replica_stats())
            return ([got[s.request_id] for s in streams],
                    [comps[s.request_id] for s in streams], sup)

    t0 = time.perf_counter()
    streamed, comps, sup = asyncio.run(drive())
    wall = time.perf_counter() - t0
    diverged = {}
    for rid, i in sup.divergences:
        diverged.setdefault(rid, set()).add(i)
    for toks, comp in zip(streamed, comps):
        check(comp.finish_reason == "length" and len(toks) == MAX_TOKENS,
              f"{label}: {comp.request_id} ended {comp.finish_reason} "
              f"after {len(toks)} tokens")
        check(len(comp.tokens) == len(toks), f"{label}: {comp.request_id} "
              f"streamed {len(toks)} tokens, its completion holds "
              f"{len(comp.tokens)} (duplicated or dropped)")
        # the completion is the last worker's history: it differs from
        # the stream only where a replayed token diverged
        differ = {i for i, (a, b) in enumerate(zip(comp.tokens, toks))
                  if a != b}
        check(differ <= diverged.get(comp.request_id, set()),
              f"{label}: {comp.request_id} differs from its completion at "
              f"{sorted(differ)}, where no replayed token diverged")
    last = snaps[-1]
    check(last["pool_free"] == last["pool_blocks"]
          and last["dense_slots_used"] == 0 and last["live_requests"] == 0,
          f"{label}: the last worker leaked: {last}")
    check(sup.n_failovers == len(failures)
          and sup.n_spawns == len(failures) + 1,
          f"{label}: {sup.n_failovers} failovers, {sup.n_spawns} spawns "
          f"for the failures {failures}")
    check(sup.n_ckpt_corruptions == failures.count("inject"),
          f"{label}: {sup.n_ckpt_corruptions} corrupted checkpoints seen")
    check(not any("watchdog" in f["reason"] for f in sup.failovers),
          f"{label}: the watchdog tripped with no stall injected")
    launches = {}
    for i, st in enumerate(snaps):
        for k, n in child_launch_gate(f"{label} incarnation {i + 1}", cfg,
                                      st).items():
            launches[k] = launches.get(k, 0) + n
    failovers = []
    for (kind, t_kill, at), f, st in zip(kills, sup.failovers, snaps[1:]):
        inc = f["incarnation"]
        t0 = t_kill if t_kill is not None else f["t_detect"]
        failovers.append(dict(
            kind=kind, at_tokens=at, reason=f["reason"],
            restored_requests=f["restored"],
            kill_to_exit_s=f["t_exit"] - t0,
            kill_to_ready_s=inc["t_ready"] - t0,
            kill_to_first_token_s=(f["t_first_token"] - t0
                                   if "t_first_token" in f else None),
            spawn_to_enter_s=inc["t_enter"] - inc["t_spawn"],
            build_s=inc["build_s"],
            capture_s=st["graph_build_s"],
            mem_free_at_ready=inc["mem_free"],
            timed_from="kill_replica call" if t_kill is not None
            else "detection of the dead worker"))
    firsts, margins = [], []
    for p, a, b in zip(prompts, want, streamed):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        firsts.append(i)
        if i is not None:
            row = rec[(tuple(p), i)]
            top = np.partition(row, -2)[-2:]
            margins.append(float((top[1] - top[0]) / row.std()))
    identical = sum(f is None for f in firsts)
    if dtype == torch.float32:
        hold_tokens(label, prompts, want, streamed)
        check(not sup.divergences, f"{label}: replayed tokens diverged at "
              f"{sup.divergences}")
    row = dict(config=cfg.name, dtype=dname(dtype), failures=failures,
               wall_s=wall,
               reference_s=ref_s, failovers=failovers,
               incarnations=len(sup.incarnations),
               replayed_tokens=sup.replayed,
               replay_divergences=len(sup.divergences),
               replay_divergence_at=sup.divergences,
               identical_requests=identical, first_divergence=firsts,
               reference_margins_at_first_divergence=margins,
               margins_under_near_tie=sum(m < SPEC_MARGIN for m in margins),
               metrics=sup.metrics.snapshot()["failover"],
               kernel_launches=launches)
    emit("supervisor", **row)
    return row, launches


# the supervised passes and their failures, one a pass (each costs a
# worker's start, about 10 s): in fp32, where replays must reproduce the
# delivered tokens exactly, a corrupted checkpoint with an injected kill
# (the restore falls back to the checkpoint before); in bf16 a kill
SUPERVISED = (("qwen2-0.5b", torch.float32, ("inject",)),
              ("qwen2-0.5b", torch.bfloat16, ("kill",)),
              ("mamba2-780m", torch.float32, ("inject",)),
              ("mamba2-780m", torch.bfloat16, ("kill",)))


def phase_supervisor():
    """The replica supervisor at full width, the workers spawned on this
    card: one ``supervised_pass`` for each of SUPERVISED.  Returns the
    children's launches by path."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, dtype, failures in SUPERVISED:
            _, launches = supervised_pass(arch, dtype, d, failures)
            key = f"{arch} supervisor"
            for k, n in launches.items():
                out.setdefault(key, {})[k] = out.get(key, {}).get(k, 0) + n
    return out



# ---------------------------------------------------------------------------
# The grid: the serving engine on a 2x2 grid of PE processes.
# ---------------------------------------------------------------------------

HEAP_SOURCE = "src/repro_torch/kernels/shmem_heap/csrc/shmem_heap.cu"
# no Pallas kernel: the XLA collectives ShmemGrid lowers to
HEAP_REPLACES = {"shmem_put": "src/repro/core/shmem.py:137",
                 "shmem_reduce_slots":
                     "src/repro/core/shmem.py:154,159,163"}
GRID_Q = GRID_R = 2
# the grid's workload: four of the engine phase's prompts, 8 greedy tokens
# (16 until the grid's training jobs joined the smoke: a cut of the path's
# steps to keep the smoke inside its clock; every gate stays)
GRID_PROMPT_LENS = [5, 40, 100, 300]
GRID_MAX_TOKENS = 8
GRID_MOE_LAYERS = 2                # of qwen3-moe's 94 (24 GB in fp32)
GRID_MOE_CF = 4.0                  # = n_pes: cap = T k, nothing can drop
# qwen2-0.5b's and mamba2-780m's bf16 jobs also at their first this many
# layers, where one extra rounding stands well out of the bf16 noise
# (deeper, every layer amplifies the roundings of both engines alike)
GRID_SHALLOW = {"qwen2-0.5b": 1, "mamba2-780m": 2}
# bf16 first-step logits of the grid against the 1x1 engine's, relative
# to each row's largest, per job: a fixed limit between the sound grid's
# reading and a control whose every grid GEMV rounds its fp32 partials to
# bf16 before the row psum (one extra rounding an op fails it), near
# their geometric mean.  On an H100, sound / control: qwen2-0.5b 0.01913
# / 0.02126, its first layer 0.00378 / 0.01148, mamba2-780m 0.2130 /
# 0.3379 (its 1x1 bf16 engine is itself 0.295 from fp32), its first two
# layers 0.00439 / 0.03999, qwen3-moe 0.0135 / 0.0235.  PERF.md has the
# readings.
GRID_BF16_TOL = {"qwen2-0.5b bf16": 0.0202, "qwen2-0.5b bf16 1L": 0.0066,
                 "mamba2-780m bf16": 0.27, "mamba2-780m bf16 2L": 0.013,
                 "qwen3-moe-235b-a22b bf16": 0.018}
GRID_PHASE_S = 300.0
# the heap messages checked and timed: qwen2-0.5b's gate|up partial (fp32,
# two slots) of a batch-8 decode step and of a batch-8 len256 chunk
HEAP_SHAPES = {"decode": (8, 1, 2 * 2432), "len256": (8, 256, 2 * 2432)}


def heap_kernels():
    """put and reduce_slots against their plain versions on a heap of this
    process (its table holds its own base), bit for bit, and timed.  Both
    copy, and add in slot order in fp32, so they must agree exactly.

    The edges: puts of fp32 and bf16 blocks at ragged sizes and offsets
    (the 16-byte and the byte path) and every (in, out) dtype pair of sum
    and max over 1, 2 and 4 slots.  The main path's messages
    (HEAP_SHAPES, where the kernels' grid-stride loops run many passes):
    the put of each in fp32 and bf16, and sum and max over 2 slots of fp32
    into fp32 (as the engine reduces them) and of bf16 into bf16.  The
    fp32 puts and sums of HEAP_SHAPES are the ones timed, against the plain
    version, one PyTorch call of the same function (``Tensor.copy_`` of
    the same bytes; ``torch.sum`` over the stacked slots) and the bytes
    bound at 3.35 TB/s, each kernel and library call by CUDA events and by
    the profiler's device time (which leaves out the wrapper's host
    time).  Returns the number of cases, each kernel's
    largest absolute difference from its plain version (bytes for the
    put) and the timing rows."""
    from repro_torch.kernels.shmem_heap import (CudaHeap, shmem_put_ref,
                                                shmem_reduce_slots_ref)
    from repro_torch.kernels.shmem_heap.kernel import (
        shmem_put_cuda, shmem_reduce_slots_cuda)
    rng = np.random.default_rng(7)
    # [0, 2 big): the reduction's slots; then the kernel's and the plain
    # version's put destinations
    big = int(np.prod(HEAP_SHAPES["len256"])) * 4
    heap = CudaHeap(0, 1, 4 * big, torch.device("cuda", 0))
    heap.open_peers([heap.handle])
    view = heap.views[0]
    cases, err = 0, {"shmem_put": 0.0, "shmem_reduce_slots": 0.0}
    rows = []

    def put_case(src, off):
        nonlocal cases
        raw = src.reshape(-1).view(torch.uint8)
        n = raw.numel()
        got = view[2 * big + off:2 * big + off + n]
        want = view[3 * big + off:3 * big + off + n]
        got.fill_(0xA5)
        want.fill_(0x5A)
        shmem_put_cuda(heap, src, 0, 2 * big + off)
        shmem_put_ref(heap, src, 0, 3 * big + off)
        torch.cuda.synchronize()
        err["shmem_put"] = max(err["shmem_put"], float(
            (got.float() - want.float()).abs().max()))
        check(torch.equal(got, raw) and torch.equal(want, raw),
              f"shmem_put {src.dtype} {tuple(src.shape)} at {off}: the "
              f"bytes differ from the source")
        cases += 1

    def reduce_case(shape, din, dout, op, n, stride):
        nonlocal cases
        got = shmem_reduce_slots_cuda(heap, 0, stride, n, shape, din, dout,
                                      op)
        want = shmem_reduce_slots_ref(heap, 0, stride, n, shape, din, dout,
                                      op)
        torch.cuda.synchronize()
        err["shmem_reduce_slots"] = max(
            err["shmem_reduce_slots"],
            float((got.float() - want.float()).abs().max()))
        check(torch.equal(got, want),
              f"shmem_reduce_slots {op} of {n} {din} slots of "
              f"{tuple(shape)} -> {dout} differs from its plain version")
        cases += 1

    def fill_slots(shape, dtype, n, stride):
        for k in range(n):
            shmem_put_ref(heap, randn(rng, shape, dtype), 0, k * stride)

    try:
        for dtype in (torch.float32, torch.bfloat16):
            for numel, off in ((1001, 256), (4097, 3), (7, 4099)):
                put_case(randn(rng, (numel,), dtype), off)
        numel = 65537
        for din in (torch.float32, torch.bfloat16):
            stride = -(-numel * torch.empty((), dtype=din).element_size()
                       // 256) * 256
            fill_slots((numel,), din, 4, stride)
            for dout in (torch.float32, torch.bfloat16):
                for op in ("sum", "max"):
                    for n in (1, 2, 4):
                        reduce_case((numel,), din, dout, op, n, stride)
        for label, shape in HEAP_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                nbytes = int(np.prod(shape)) * torch.empty(
                    (), dtype=dtype).element_size()
                put_case(randn(rng, shape, dtype), 0)
                fill_slots(shape, dtype, 2, nbytes)
                for op in ("sum", "max"):
                    reduce_case(shape, dtype, dtype, op, 2, nbytes)
            nbytes = int(np.prod(shape)) * 4
            src = randn(rng, shape, torch.float32)
            dst = view[2 * big:2 * big + nbytes]
            raw = src.view(-1).view(torch.uint8)
            fill_slots(shape, torch.float32, 2, nbytes)
            slots = view[:2 * nbytes].view(torch.float32).view(2, -1)
            def put_k(i):
                shmem_put_cuda(heap, src, 0, 2 * big)

            def put_lib(i):
                dst.copy_(raw)

            def red_k(i):
                shmem_reduce_slots_cuda(heap, 0, nbytes, 2, shape,
                                        torch.float32, torch.float32)

            def red_lib(i):
                torch.sum(slots, dim=0)
            # events time around back-to-back calls (the wrapper's host
            # time where it exceeds the kernel's) beside the profiler's
            # device time of the kernel or copy alone
            put = dict(
                ms=cuda_ms(put_k, 50),
                device_ms=device_ms(put_k, 50, ("put_kernel",)),
                plain_ms=cuda_ms(lambda i: shmem_put_ref(heap, src, 0,
                                                         2 * big), 50),
                library_ms=cuda_ms(put_lib, 50),
                library_device_ms=device_ms(put_lib, 50, ("Memcpy",)),
                bound_ms=2 * nbytes / HBM_BYTES_S * 1e3)
            red = dict(
                ms=cuda_ms(red_k, 50),
                device_ms=device_ms(red_k, 50, ("reduce_kernel",)),
                plain_ms=cuda_ms(lambda i: shmem_reduce_slots_ref(
                    heap, 0, nbytes, 2, shape, torch.float32, torch.float32),
                    50),
                library_ms=cuda_ms(red_lib, 50),
                library_device_ms=device_ms(red_lib, 50, ("reduce_kernel",)),
                bound_ms=3 * nbytes / HBM_BYTES_S * 1e3)
            for name, t in (("shmem_put", put), ("shmem_reduce_slots", red)):
                rows.append(dict(kernel=name, shape=label, bytes=nbytes,
                                 bound_by="bytes", **t))
                emit("heap_timing", **rows[-1])
    finally:
        heap.close_peers()
        heap.free()
    return cases, err, rows


def grid_cfg(arch, dtype, **kw):
    """``arch`` in ``dtype`` as the grid phase serves it: qwen3-moe at
    GRID_MOE_LAYERS of its 94 at capacity_factor GRID_MOE_CF, qwen2-0.5b
    and mamba2-780m whole, jamba reduced (fp32), each with ``kw`` on
    top."""
    from repro_torch.configs import get_config, reduced
    if arch == "jamba":
        return dataclasses.replace(
            reduced(get_config("jamba-1.5-large-398b")), **kw)
    cfg = get_config(arch)
    if arch == "qwen3-moe-235b-a22b":
        kw.setdefault("n_layers", GRID_MOE_LAYERS)
        kw.setdefault("capacity_factor", GRID_MOE_CF)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                               **kw)


def grid_table():
    """The grid phase's jobs, as (label, config, passes, profiled,
    compared with the 1x1 engine): qwen2-0.5b, mamba2-780m and qwen3-moe
    (cf GRID_MOE_CF) each in fp32 and in bf16 (two passes, profiled),
    qwen2-0.5b and mamba2-780m in bf16 at their first GRID_SHALLOW layers,
    qwen3-moe in bf16 at capacity_factor 1.25 and the reduced jamba in
    fp32 (cf GRID_MOE_CF)."""
    f32, b16 = torch.float32, torch.bfloat16
    moe = "qwen3-moe-235b-a22b"
    table = [(f"{arch} {d}", grid_cfg(arch, dt), 2 if dt == b16 else 1,
              dt == b16, True)
             for arch in ("qwen2-0.5b", "mamba2-780m", moe)
             for d, dt in (("fp32", f32), ("bf16", b16))]
    table += [(f"{arch} bf16 {n}L", grid_cfg(arch, b16, n_layers=n), 1,
               False, True) for arch, n in GRID_SHALLOW.items()]
    return table + [
        (f"{moe} bf16 cf1.25", grid_cfg(moe, b16, capacity_factor=1.25), 1,
         False, False),
        ("jamba fp32", grid_cfg("jamba", f32, capacity_factor=GRID_MOE_CF),
         1, False, True)]


def one_device_passes(cfg, prompts, sampling, passes=2):
    """The 1x1 engine (graphs) on the seed-0 weights, the workload served
    ``passes`` times: the first pass's tokens and recorded rows, the
    second pass's tokens/s and wall (warm: the prompts' pages in the
    prefix cache, the steps captured; in bf16 its tokens may differ from
    the first pass's, whose prefill ran in other chunks)."""
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineStats, ServingEngine, generate
    gen = torch.Generator("cuda").manual_seed(0)
    eng = ServingEngine(cfg, params=init_params(cfg, generator=gen,
                                                device="cuda"),
                        engine_cfg=smoke_ec())
    rec, _ = record_rows(eng)
    outs = [c.tokens for c in generate(eng, prompts, sampling)]
    rows = dict(rec)
    out = dict(tokens=outs, rows=rows)
    if passes >= 2:
        eng.stats = EngineStats()
        for ev in eng.kernel_events().values():
            ev.first_enqueue_t = ev.last_enqueue_t = ev.last_done_t = 0.0
        t0 = time.perf_counter()
        generate(eng, prompts, sampling)
        wall = time.perf_counter() - t0
        out.update(tokens_per_s=eng.throughput_tok_s(), wall_s=wall,
                   steps=eng.stats.steps)
    del eng, gen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_steps_summary(reports, cfg, plan, lo=0, hi=None):
    """Per-step numbers of one job over steps [lo, hi): PE 0's wall per
    step, the collectives and barrier-wait share per PE, the heap bytes
    over all PEs against the reckoned count."""
    from repro_torch.serve.engine.grid import (heap_bytes_by_step, pe_heads,
                                               reckoned_heap_bytes)
    hq, kvh = pe_heads(cfg, plan)
    logs = [r["grid_log"][lo:hi] for r in reports]
    names = [s["name"] for s in logs[0]]
    got = heap_bytes_by_step(reports)[lo:hi]
    want = [reckoned_heap_bytes(cfg, plan, n, hq, kvh) for n in names]
    decode = [k for k, n in enumerate(names) if n.startswith("serve_step")]
    walls = [s["wall_s"] for s in logs[0]]
    return dict(
        steps=len(names), decode_steps=len(decode),
        step_wall_ms=1e3 * float(np.mean(walls)),
        decode_step_wall_ms=1e3 * float(np.mean([walls[k] for k in decode]))
        if decode else None,
        collectives_per_step=float(np.mean([s["collectives"]
                                            for s in logs[0]])),
        puts_per_step_per_pe=float(np.mean([s["puts"] for s in logs[0]])),
        barrier_wait_share={r["pe"]: sum(s["wait_s"] for s in log)
                            / max(sum(s["wall_s"] for s in log), 1e-9)
                            for r, log in zip(reports, logs)},
        heap_bytes_per_step=float(np.mean(got)),
        heap_bytes_reckoned_per_step=float(np.mean(want)),
        heap_bytes_equal=got == want), got == want


def layer_counts(cfg):
    """Layers of each kind in ``cfg``: attention, mamba, MoE."""
    pattern = cfg.pattern()
    return {kind: cfg.n_groups() * sum(kind in pair for pair in pattern)
            for kind in ("attn", "mamba", "moe")}


def check_grid_job(label, cfg, reports, plan, max_tokens):
    """The gates of one grid job on every PE (``phase_grid``); returns its
    kernels' launches summed over the PEs."""
    from repro_torch.serve.decode import grid_messages
    from repro_torch.serve.engine.grid import pe_heads, step_shape
    check(len(reports) == plan.n_pes
          and all(r["device"].startswith("cuda") and r["heap"] == "CudaHeap"
                  and r["backend"] == "gloo" for r in reports),
          f"grid {label}: not four PEs on CUDA with CUDA-IPC heaps over "
          f"gloo: {[(r['device'], r['heap'], r['backend']) for r in reports]}")
    pe0 = reports[0]
    check(all(f == "length" for f in pe0["finish"])
          and all(len(t) == max_tokens for t in pe0["tokens"]),
          f"grid {label}: a request did not end with its {max_tokens} "
          f"tokens")
    hq, kvh = pe_heads(cfg, plan)
    kinds = layer_counts(cfg)
    bf16 = cfg.compute_dtype == torch.bfloat16
    launches = {}
    for r in reports:
        n, log = r["launches"], r["grid_log"]
        steps = len(log)
        chunks = sum(s["name"].startswith("prefill") for s in log)
        where = f"grid {label} PE {r['pe']}"
        plain = {k: v for k, v in n.items() if k.endswith("_ref") and v}
        check(not plain, f"{where}: plain versions ran: {plain}")
        want = {"paged_attention_cuda": steps * kinds["attn"],
                "grouped_mm_cuda": steps * kinds["moe"],
                "grouped_mm_swiglu_cuda": steps * kinds["moe"],
                "ssd_scan_fused_cuda": chunks * kinds["mamba"] * bf16,
                "ssd_chunk_cuda": chunks * kinds["mamba"] * (not bf16),
                "ssd_apply_cuda": chunks * kinds["mamba"] * (not bf16)}
        got = {k: n.get(k, 0) for k in want}
        check(got == want and (not kinds["mamba"] or chunks),
              f"{where}: kernel launches {got}, expected {want} over "
              f"{steps} steps ({chunks} chunks) of {kinds}")
        puts = sum(s["puts"] for s in log)
        reductions = sum(sum(1 for m in grid_messages(
            cfg, plan, *step_shape(s["name"])[:2], hq=hq, kvh=kvh)
            if "psum" in m.what or "pmax" in m.what) for s in log)
        check(n.get("shmem_put_cuda", 0) == puts
              and n.get("shmem_reduce_slots_cuda", 0) == reductions,
              f"{where}: heap kernels {n} against {puts} puts and "
              f"{reductions} reductions")
        for k, v in n.items():
            if v:
                launches[k] = launches.get(k, 0) + v
    return launches


def grid_prepare():
    """The grid phase: the serving engine on a 2x2 grid of PE processes on
    this card (``serve/engine/grid.py``), its jobs in the spawn
    ``phase_grids`` shares with grid_forward: the heap's kernels
    against their plain versions and timed, the parts of one collective
    timed on the four PEs (``probe_latency``), then GRID_PROMPT_LENS'
    prompts with GRID_MAX_TOKENS greedy tokens on the jobs of
    ``grid_table``: qwen2-0.5b (24 layers), mamba2-780m (48 layers) and
    qwen3-moe (full width, GRID_MOE_LAYERS layers, capacity_factor
    GRID_MOE_CF = n_pes: nothing can drop), each in fp32 and in bf16
    (served twice under torch.profiler on every PE; the second pass
    timed), qwen2-0.5b and mamba2-780m in bf16 at their first
    GRID_SHALLOW layers, each beside
    the 1x1 engine on the same seed-0 weights; qwen3-moe once more in bf16
    at the config's capacity_factor 1.25 (the share of dropped pairs); the
    reduced jamba (attention, mamba and MoE layers) in fp32.  Gates: four
    PE processes on CUDA with CUDA-IPC heaps over gloo (no NCCL), no plain
    version run, on every PE paged attention on every attention layer of
    every step (``qrows`` 2), the fused SSD scan (bf16) or its two simt
    passes (fp32) on every mamba layer of every chunk step, both grouped
    GEMMs on every MoE layer of every step, the heap kernels' launches as
    the steps' puts and reductions imply; fp32 tokens equal to the 1x1
    engine's; bf16 first-step logits (the prompts' last positions, from
    the same tokens in both) within GRID_BF16_TOL[label] of the 1x1
    engine's; every step's heap bytes equal to the count reckoned from the
    shapes.  Here the work before the spawn (the heap kernels, the 1x1
    engines, the jobs); ``grid_check`` gates the reports."""
    from repro_torch.partition import grid_plan
    from repro_torch.serve.engine import SamplingParams
    from repro_torch.serve.engine.grid import GridJob
    t0 = time.perf_counter()
    cases, heap_err, timing = heap_kernels()
    emit("heap_vs_plain", cases=cases, max_abs_err=heap_err)
    plan = grid_plan(GRID_Q, GRID_R)
    sampling = SamplingParams(max_tokens=GRID_MAX_TOKENS)
    table = grid_table()
    prompts = {}
    for label, cfg, *_ in table:
        rng = np.random.default_rng(0)
        prompts[label] = [rng.integers(0, cfg.vocab_size, n).tolist()
                          for n in GRID_PROMPT_LENS]
    t_one = time.perf_counter()
    one = {label: one_device_passes(cfg, prompts[label], sampling, passes)
           for label, cfg, passes, _, ref in table if ref}
    one_s = time.perf_counter() - t_one
    jobs = [GridJob(cfg, smoke_ec(), prompts[label], sampling, seed=0,
                    record=2, passes=passes, profile=profile)
            for label, cfg, passes, profile, _ in table]
    return dict(plan=plan, table=table, prompts=prompts, one=one,
                one_s=one_s, timing=timing, heap_err=heap_err, jobs=jobs,
                prep_s=time.perf_counter() - t0)


def grid_check(smi, prep, runs, latency, spawn_s):
    """The grid phase's gates and rows on its jobs' reports (``runs``, per
    job every PE's), ``latency`` the collective's parts timed on every PE
    and ``spawn_s`` the phase's share of the shared spawn: returns
    (launches by job, the heap kernels' rows, their errors) and the
    phase's seconds."""
    t0 = time.perf_counter()
    plan, table, prompts, one = (prep[k] for k in ("plan", "table",
                                                   "prompts", "one"))
    timing, heap_err = prep["timing"], prep["heap_err"]
    launches, failed, grid_rows = {}, [], {}
    for (label, cfg, passes, profile, ref), reports in zip(table, runs):
        launches[label] = check_grid_job(label, cfg, reports, plan,
                                         GRID_MAX_TOKENS)
        summary, equal = grid_steps_summary(reports, cfg, plan)
        check(equal, f"grid {label}: heap bytes per step differ from the "
                     f"reckoned count")
        pe0 = reports[0]
        row = dict(run=label, layers=cfg.n_layers,
                   heap_bytes_per_pe=pe0["heap_bytes"],
                   heap_slot_bytes=pe0["heap_slot_bytes"],
                   tokens_per_s=pe0["tokens_per_s"], wall_s=pe0["wall_s"],
                   pe_wall_s={r["pe"]: r["pe_wall_s"] for r in reports},
                   state_commands=pe0["state_commands"],
                   launches_by_pe={r["pe"]: {
                       k: v for k, v in r["launches"].items() if v}
                       for r in reports}, **summary)
        if pe0["moe_pairs"]:
            row.update(capacity_factor=cfg.capacity_factor,
                       moe_pairs=pe0["moe_pairs"],
                       moe_dropped=pe0["moe_dropped"],
                       moe_dropped_share=pe0["moe_dropped"]
                       / pe0["moe_pairs"])
            check(cfg.capacity_factor < plan.n_pes
                  or pe0["moe_dropped"] == 0,
                  f"grid {label}: {pe0['moe_dropped']} pairs dropped at "
                  f"capacity_factor {cfg.capacity_factor}")
        if passes > 1:
            lo, hi = pe0["passes"][1]["steps"]
            row["warm"], _ = grid_steps_summary(reports, cfg, plan, lo, hi)
            row.update(warm_tokens_per_s=pe0["passes"][1]["tokens_per_s"],
                       warm_wall_s=pe0["passes"][1]["wall_s"])
        if profile:
            row.update(
                device_busy_ms_per_step_by_pe={
                    r["pe"]: (r["busy_ms"] / len(r["grid_log"])
                              if r.get("kernel_records") else "not measured")
                    for r in reports},
                kernel_records_by_pe={r["pe"]: r.get("kernel_records")
                                      for r in reports},
                profiled_steps=len(pe0["grid_log"]))
        if ref:
            row.update(compare_1x1(label, cfg, prompts[label], one[label],
                                   pe0))
            failed += row["failed"]
            grid_rows[label] = pe0["rows"]
        emit("grid_run", **row, nvidia_smi=smi)
    # each bf16 job's noise beside its gate where an fp32 job of the same
    # model and depth ran: the 1x1 bf16 engine's and the grid's first-step
    # logits from the 1x1 fp32 engine's (the bf16 weights are the fp32
    # ones rounded)
    for label in grid_rows:
        ref = label.replace(" bf16", " fp32")
        if ref == label or ref not in one:
            continue
        want, ps = one[ref]["rows"], prompts[ref]
        emit("grid_bf16_noise", run=label, one_bf16_from_fp32=max(
            rel_err(torch.from_numpy(want[(tuple(p), 0)]), torch.from_numpy(
                one[label]["rows"][(tuple(p), 0)])) for p in ps),
             grid_bf16_from_fp32=max(
                 rel_err(torch.from_numpy(want[(tuple(ps[k]), 0)]),
                         torch.from_numpy(row))
                 for (k, n), row in grid_rows[label].items()
                 if n == 0), nvidia_smi=smi)
    check(not failed, "; ".join(failed))
    phase_s = prep["prep_s"] + spawn_s + time.perf_counter() - t0
    emit("grid", jobs=[label for label, *_ in table],
         collective_parts_us_by_pe=dict(enumerate(latency)),
         one_device_s=prep["one_s"], grid_spawn_and_serve_s=spawn_s,
         phase_s=phase_s, nvidia_smi=smi)
    check(phase_s < GRID_PHASE_S, f"the grid phase took {phase_s:.0f} s")
    return (launches, timing, heap_err), phase_s


def compare_1x1(label, cfg, prompts, one, pe0):
    """A grid job's first pass against the 1x1 engine's: fp32 tokens
    equal, bf16 first-step logits within GRID_BF16_TOL (the gates: their
    failures under ``failed``, which ``phase_grid`` checks once every job
    is reported), the first decode step's and the tokens' agreement, warm
    tokens/s.  The
    first step's logits come from the same tokens in both engines; the
    first decode step's are compared only where the first sampled tokens
    agree (a bf16 near-tie may pick another token there)."""
    def errs(out_idx, keys=None):
        return {k[0]: rel_err(torch.from_numpy(one["rows"][
            (tuple(prompts[k[0]]), k[1])]), torch.from_numpy(row))
            for k, row in pe0["rows"].items() if k[1] == out_idx
            and (keys is None or k[0] in keys)}
    first = errs(0)
    same0 = {n for n, (g, w) in enumerate(zip(pe0["tokens"], one["tokens"]))
             if g[0] == w[0]}
    decode = errs(1, same0)
    agree = [sum(a == b for a, b in zip(g, w))
             for g, w in zip(pe0["tokens"], one["tokens"])]
    out = dict(first_step_logits_max_rel_err=max(first.values()),
               first_decode_logits_max_rel_err=max(decode.values())
               if decode else None,
               tokens_agreeing=sum(agree),
               tokens=sum(len(t) for t in pe0["tokens"]),
               tokens_equal_1x1=pe0["tokens"] == one["tokens"])
    failed = []
    if len(first) != len(prompts):
        failed.append(f"grid {label}: {len(first)} first steps recorded")
    if cfg.compute_dtype == torch.float32:
        if not out["tokens_equal_1x1"]:
            failed.append(f"grid {label}: greedy tokens differ from the 1x1 "
                          f"engine's")
    else:
        tol = GRID_BF16_TOL[label]
        out["first_step_tolerance"] = tol
        if out["first_step_logits_max_rel_err"] > tol:
            failed.append(f"grid {label}: first step's logits "
                          f"{out['first_step_logits_max_rel_err']} from the "
                          f"1x1 engine's (tolerance {tol})")
    out["failed"] = failed
    if "tokens_per_s" in one:
        out.update(warm_tokens_per_s_1x1=one["tokens_per_s"],
                   warm_wall_s_1x1=one["wall_s"])
    return out


# ---------------------------------------------------------------------------
# The blocked layout on the grid: the forward (loss and prefill) under the
# paper's Cannon GEMMs and their baselines, and the batched decode, on a
# 2x2 grid of PE processes.
# ---------------------------------------------------------------------------

GRID_FWD_BATCH, GRID_FWD_SEQ = 2, 1024       # S_loc 512 a grid row
# 8 greedy tokens (16 until the training jobs joined the spawn: a cut of
# the path's steps to keep the smoke inside its clock; every gate stays)
GRID_DEC_BATCH, GRID_DEC_S_MAX, GRID_DEC_STEPS = 8, 512, 8
# each forward runs once: the first job (the small jamba) takes the PEs'
# first launches, so the timed qwen2 and mamba2 forwards find them warm
GRID_FWD_RUNS = 1
GRID_STRATEGIES = ("cannon", "cannon_opt", "allgather", "summa")
# fp32 against the port's 1x1 on the same weights: the loss, the prefill's
# last-position logits (relative to the largest) and the first decode
# step's logits, the bound the CPU tests hold the grid to against JAX
GRID_FWD_TOL = 1e-5
# mamba2-780m's 48 random fp32 layers amplify summation order: its logits
# (not its loss) take this bound instead, 4x the 1x1's own spread between
# its two fp32 scan routes on the same weights (the SSD kernels against the
# differentiable torch scan: 1.25e-4 on an H100); the grid reads 1.38e-4 to
# 1.41e-4 at the last position, 2.56e-5 at the first decode step.  (A grid
# without the state relay reads the same at the last position, where the
# relayed state has decayed away: the loss, held at GRID_FWD_TOL, fails it
# at 3.1e-4.)
GRID_FWD_DEEP_TOL = {"mamba2-780m fp32": 5e-4}
# bf16 prefill logits (and the first batched-decode step's) against the 1x1
# bf16 run's, relative to the largest: a limit between the sound grid's
# reading and a control whose every local block product is rounded to bf16
# before the fp32 accumulation (one extra rounding a GEMM step), near their
# geometric mean.  On an H100, sound / control: qwen2-0.5b prefill 0.01698
# (cannon; cannon_opt 0.01649) / 0.02142, its first decode step 0.02075 /
# 0.02494, mamba2-780m prefill 0.1286 / 0.2637.  PERF.md has the readings.
GRID_FWD_BF16_TOL = {"qwen2-0.5b bf16": 0.019, "mamba2-780m bf16": 0.18,
                     "qwen2-0.5b bf16 decode": 0.0227}
GRID_FWD_PHASE_S = 300.0


def grid_forward_table():
    """The forward jobs, as (label, config, strategies): the reduced
    jamba (attention, mamba and MoE layers, capacity_factor GRID_MOE_CF:
    nothing can drop) in fp32 under cannon and cannon_opt; qwen2-0.5b (24
    layers) in fp32 under all four strategies and in bf16 under cannon
    and cannon_opt; mamba2-780m (48 layers) in fp32 under cannon and
    cannon_opt and in bf16 under cannon."""
    f32, b16 = torch.float32, torch.bfloat16
    S = GRID_STRATEGIES
    return [("jamba fp32", grid_cfg("jamba", f32,
                                    capacity_factor=GRID_MOE_CF), S[:2]),
            ("qwen2-0.5b fp32", grid_cfg("qwen2-0.5b", f32), S),
            ("qwen2-0.5b bf16", grid_cfg("qwen2-0.5b", b16), S[:2]),
            ("mamba2-780m fp32", grid_cfg("mamba2-780m", f32), S[:2]),
            ("mamba2-780m bf16", grid_cfg("mamba2-780m", b16), S[:1])]


# the batched decode's jobs (labels of grid_forward_table)
GRID_DECODE = ("qwen2-0.5b fp32", "qwen2-0.5b bf16", "mamba2-780m fp32")


def grid_denses(cfg):
    """Distributed GEMMs of one forward: two a layer (QKV and wo, in and
    out projections, gate|up and down; the MoE router is a local fp32
    product summed over the columns) and the lm_head."""
    per = {"attn": 2, "mamba": 2, "mlp": 2, "moe": 0, "none": 0}
    return cfg.n_groups() * sum(per[m] + per[f] for m, f in cfg.pattern()) \
        + 1


def one_device_blocked(cfg, toks, labels, first):
    """The port's 1x1 on the seed-0 weights drawn on the card: the loss,
    the prefill's last-position logits and, with ``first``, the batched
    decode's greedy tokens and its first step's logits."""
    from repro_torch.models.params import init_params
    from repro_torch.serve.decode import (cache_specs, make_decode_step,
                                          make_prefill)
    from repro_torch.train.step import make_loss_fn
    gen = torch.Generator(DEV).manual_seed(0)
    params = init_params(cfg, generator=gen, device=DEV)
    batch = {"tokens": torch.from_numpy(toks).to(DEV),
             "labels": torch.from_numpy(labels).to(DEV)}
    loss, _ = make_loss_fn(cfg)(params, batch)
    out = {"loss": float(loss),
           "logits": make_prefill(cfg)(params, batch)[:, 0].float().cpu()}
    if first is not None:
        B = len(first)
        step = make_decode_step(cfg, batch=B, s_max=GRID_DEC_S_MAX)
        cache = cache_specs(cfg, B, GRID_DEC_S_MAX, "batched", device=DEV)
        tok = torch.from_numpy(first.astype(np.int32)).to(DEV)
        seq = [tok]
        for t in range(GRID_DEC_STEPS):
            logits = step(params, cache, tok, t)
            if t == 0:
                out["first_row"] = logits[:, 0].float().cpu()
            tok = torch.argmax(logits[:, 0, :cfg.vocab_size], -1).to(
                torch.int32)
            seq.append(tok)
        out["tokens"] = torch.stack(seq, 1).cpu().numpy()
        del cache
    del params, gen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_forward_pe(where, cfg, strategy, r, one, plan):
    """One PE's forward job (``phase_grid_forward``): heap bytes as
    reckoned every run, no plain version, the cannon_mm kernel on every
    distributed GEMM (q launches a Cannon, crot or SUMMA GEMM, one an
    allgather one), the SSD scan's two passes on every mamba layer (the
    ``mma`` variant in bf16, ``simt`` in fp32), both grouped GEMMs on
    every MoE layer; fp32 results within GRID_FWD_TOL of the 1x1's."""
    kinds = layer_counts(cfg)
    bf16 = cfg.compute_dtype == torch.bfloat16
    per_gemm = 1 if strategy == "allgather" else plan.grid_q
    failed = []
    for what in ("loss", "prefill"):
        for k, rec in enumerate(r[f"{what}_runs"]):
            n = {name: c["launches"] for name, c in rec["launches"].items()}
            if rec["heap_bytes"] != r["reckoned_heap_bytes"][what]:
                failed.append(f"{where} {what} run {k}: heap bytes "
                              f"{rec['heap_bytes']}, reckoned "
                              f"{r['reckoned_heap_bytes'][what]}")
            plain = {name: v for name, v in n.items()
                     if name.endswith("_ref") and v}
            want = {"matmul_cuda": grid_denses(cfg) * per_gemm,
                    "ssd_chunk_cuda": kinds["mamba"],
                    "ssd_apply_cuda": kinds["mamba"],
                    "grouped_mm_cuda": kinds["moe"],
                    "grouped_mm_swiglu_cuda": kinds["moe"]}
            got = {name: n.get(name, 0) for name in want}
            if plain or got != want:
                failed.append(f"{where} {what} run {k}: launches {got}, "
                              f"expected {want}; plain {plain}")
            variant = "mma" if bf16 else "simt"
            for name in ("ssd_chunk_cuda", "ssd_apply_cuda"):
                var = rec["launches"].get(name, {}).get("by_variant", {})
                if kinds["mamba"] and var.get(variant) != kinds["mamba"]:
                    failed.append(f"{where} {what}: {name} by variant {var}"
                                  f", expected {variant}")
    if r["device"][:4] != "cuda" or r["heap"] != "CudaHeap":
        failed.append(f"{where}: {r['device']} with a {r['heap']}")
    V = cfg.vocab_size
    errs = {"loss_rel_err": abs(r["loss"] - one["loss"]) / abs(one["loss"]),
            "logits_rel_err": rel_err(one["logits"][..., :V], torch.from_numpy(
                r["logits"][:, 0, :V]))}
    label = f"{cfg.name} {'bf16' if bf16 else 'fp32'}"
    tol = {"loss_rel_err": GRID_FWD_TOL,
           "logits_rel_err": GRID_FWD_BF16_TOL.get(label) if bf16
           else GRID_FWD_DEEP_TOL.get(label, GRID_FWD_TOL)}
    for k, e in errs.items():
        if tol[k] is not None and not (bf16 and k == "loss_rel_err") \
                and e > tol[k]:
            failed.append(f"{where}: {k} {e} from the 1x1 (tolerance "
                          f"{tol[k]})")
    return errs, failed


def check_decode_pe(where, cfg, label, r, one):
    """One PE's batched decode job: heap bytes as reckoned every step, no
    plain version, cannon_mm on every GEMM of every step (q launches
    each); fp32 tokens equal to the 1x1's, the first step's logits within
    GRID_FWD_TOL (fp32) or GRID_FWD_BF16_TOL (bf16)."""
    failed = []
    want = grid_denses(cfg) * GRID_Q
    for k, rec in enumerate(r["steps"]):
        n = {name: c["launches"] for name, c in rec["launches"].items()}
        if rec["heap_bytes"] != r["reckoned_heap_bytes"]:
            failed.append(f"{where} step {k}: heap bytes {rec['heap_bytes']}"
                          f", reckoned {r['reckoned_heap_bytes']}")
        plain = {name: v for name, v in n.items()
                 if name.endswith("_ref") and v}
        if plain or n.get("matmul_cuda", 0) != want:
            failed.append(f"{where} step {k}: cannon_mm {n.get('matmul_cuda')}"
                          f" (expected {want}), plain {plain}")
    V = cfg.vocab_size
    err = rel_err(one["first_row"][:, :V],
                  torch.from_numpy(r["rows"][0][:, :V]))
    equal = bool(np.array_equal(r["tokens"], one["tokens"]))
    if cfg.compute_dtype == torch.float32:
        tol = GRID_FWD_DEEP_TOL.get(label, GRID_FWD_TOL)
        if not equal:
            failed.append(f"{where}: greedy tokens differ from the 1x1's")
        if err > tol:
            failed.append(f"{where}: first-step logits {err} from the 1x1 "
                          f"(tolerance {tol})")
    elif err > GRID_FWD_BF16_TOL[f"{label} decode"]:
        failed.append(f"{where}: first-step logits {err} from the 1x1 "
                      f"(tolerance {GRID_FWD_BF16_TOL[f'{label} decode']})")
    return {"first_step_rel_err": err, "tokens_equal_1x1": equal}, failed


def _walls(reports, runs_key):
    """(PE 0's wall, the slowest PE's) of the last run, ms."""
    walls = [r[runs_key][-1]["wall_s"] * 1e3 for r in reports]
    return walls[0], max(walls)


def grid_forward_prepare():
    """The grid_forward phase: the blocked layout on a 2x2 grid of PE
    processes of this card (``launch/grid_run.py``), its jobs in the spawn
    ``phase_grids`` shares with the grid phase: ``make_loss_fn`` and
    ``make_prefill`` on batch GRID_FWD_BATCH x GRID_FWD_SEQ tokens (S_loc
    512 a row) for the jobs of ``grid_forward_table``, each run
    GRID_FWD_RUNS times (the last timed), and ``make_decode_step(mode=
    "batched")`` under Cannon for GRID_DECODE: batch GRID_DEC_BATCH (4 a
    row), ``s_max`` GRID_DEC_S_MAX, GRID_DEC_STEPS greedy tokens from one
    random token a row.  Every job beside the port's 1x1 on the same
    seed-0 weights (drawn on the card; the PEs draw them in turn and cut
    their blocks in the strategy's storage).  Gates on every PE
    (``check_forward_pe``, ``check_decode_pe``): fp32 loss, prefill logits
    and first decode logits within GRID_FWD_TOL of the 1x1's, fp32 decode
    tokens equal, the fp32 strategies within GRID_FWD_TOL of each other,
    bf16 logits within GRID_FWD_BF16_TOL; heap bytes of every forward and
    decode step as reckoned from the shapes; cannon_mm on every GEMM, the
    SSD passes on every mamba layer, the grouped GEMMs on every MoE layer,
    no plain version.  Prints per strategy the ms per forward and per
    decode step, collectives, heap bytes per PE and the barrier-wait
    share.  The training jobs of ``grid_train_table`` run in the same
    spawn, after the others (``grid_train_rows`` gates and prints them).
    Here the work before the spawn (the 1x1 runs, the jobs);
    ``grid_forward_check`` gates the reports."""
    from repro_torch.launch.grid_run import DecodeJob, ForwardJob, make_batch
    from repro_torch.partition import grid_plan
    t0 = time.perf_counter()
    plan = grid_plan(GRID_Q, GRID_R)
    table = grid_forward_table()
    cfgs = {label: cfg for label, cfg, _ in table}
    inputs, one = {}, {}
    t_one = time.perf_counter()
    for label, cfg, _ in table:
        toks, labels = make_batch(cfg, GRID_FWD_BATCH, GRID_FWD_SEQ)
        first = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(GRID_DEC_BATCH,)) \
            if label in GRID_DECODE else None
        inputs[label] = (toks, labels, first)
        one[label] = one_device_blocked(cfg, toks, labels, first)
    # the training jobs' 1x1 runs, each model's once (the strategies of a
    # model share it), its final blocks saved where a job holds them
    from repro_torch.launch.grid_run import TrainJob
    from repro_torch.models.params import storage_for
    train_table = grid_train_table()
    one_train, train_inputs = {}, {}
    for label, cfg, strategy, bits, held in train_table:
        if label in one_train:
            continue
        toks, labels = make_batch(cfg, GRID_FWD_BATCH, GRID_FWD_SEQ)
        train_inputs[label] = (toks, labels)
        storages = sorted({storage_for(st) for lb, _, st, _, h
                           in train_table if lb == label and h}, key=str)
        one_train[label] = one_device_train(label, cfg, bits, toks, labels,
                                            storages, plan)
    one_s = time.perf_counter() - t_one
    jobs, keys = [], []
    for label, cfg, strategies in table:
        toks, labels, _ = inputs[label]
        for s in strategies:
            keys.append((label, s))
            jobs.append(ForwardJob(cfg, s, toks, labels, seed=0,
                                   runs=GRID_FWD_RUNS))
    for label in GRID_DECODE:
        keys.append((label, "decode"))
        jobs.append(DecodeJob(cfg=cfgs[label], first=inputs[label][2],
                              s_max=GRID_DEC_S_MAX, steps=GRID_DEC_STEPS,
                              seed=0))
    for label, cfg, strategy, bits, held in train_table:
        toks, labels = train_inputs[label]
        jobs.append(TrainJob(
            cfg, strategy, [(toks, labels)] * GRID_TRAIN_STEPS, seed=0,
            opt=dict(GRID_TRAIN_OPT, state_bits=bits),
            compare_to=one_train[label]["files"][storage_for(strategy)]
            if held else None))
    return dict(plan=plan, cfgs=cfgs, one=one, keys=keys,
                train_table=train_table, one_train=one_train, jobs=jobs,
                one_s=one_s, prep_s=time.perf_counter() - t0)


def grid_forward_check(smi, prep, runs, spawn_s, pe_start_s, end_s):
    """The grid_forward phase's gates and rows on its jobs' reports
    (``runs``, per job every PE's, the training jobs last); ``spawn_s`` is
    its share of the shared spawn, ``pe_start_s`` and ``end_s`` the PEs'
    start and end in it.  Returns the launches by path (summed over the
    PEs, the forward's last run, every decode step and every training
    step), the rows and the phase's seconds."""
    t0 = time.perf_counter()
    plan, cfgs, one, keys, train_table, one_train = (prep[k] for k in (
        "plan", "cfgs", "one", "keys", "train_table", "one_train"))
    train_runs, runs = runs[len(keys):], runs[:len(keys)]
    failed, rows, by_path = [], [], {}
    fp32_results = {}
    for (label, s), reports in zip(keys, runs):
        cfg = cfgs[label]
        path = f"{label} {s} grid 2x2 " + (
            "(batched decode)" if s == "decode" else "(loss + prefill)")
        row = dict(run=label, strategy=s, layers=cfg.n_layers,
                   heap_slot_bytes=reports[0]["heap_slot_bytes"],
                   job_s=max(r["job_s"] for r in reports),
                   setup_s=max(r["setup_s"] for r in reports))
        for r in reports:
            where = f"grid_forward {label} {s} PE {r['pe']}"
            if s == "decode":
                errs, bad = check_decode_pe(where, cfg, label, r, one[label])
            else:
                errs, bad = check_forward_pe(where, cfg, s, r, one[label],
                                             plan)
            failed += bad
            for k, v in errs.items():
                row.setdefault(k + "_by_pe", {})[r["pe"]] = v
            recs = r["steps"] if s == "decode" else \
                r["loss_runs"][-1:] + r["prefill_runs"][-1:]
            for rec in recs:
                for name, c in rec["launches"].items():
                    if not name.endswith("_cuda"):
                        continue
                    k = name[:-len("_cuda")]
                    e = by_path.setdefault(k, {}).setdefault(
                        path, {"launches": 0, "by_variant": {}})
                    e["launches"] += c["launches"]
                    for v, m in c["by_variant"].items():
                        if m:
                            e["by_variant"][v] = e["by_variant"].get(v, 0) + m
        pe0 = reports[0]
        if s == "decode":
            st = pe0["steps"][1:]           # the first step warms up
            wall = float(np.mean([x["wall_s"] for x in st])) * 1e3
            row.update(ms_per_decode_step=wall,
                       ms_per_decode_step_slowest_pe=max(
                           1e3 * float(np.mean([x["wall_s"]
                                                for x in r["steps"][1:]]))
                           for r in reports),
                       collectives_per_step=st[0]["collectives"],
                       heap_bytes_per_pe_per_step=st[0]["heap_bytes"],
                       barrier_wait_share={r["pe"]: sum(
                           x["wait_s"] for x in r["steps"][1:]) / max(sum(
                               x["wall_s"] for x in r["steps"][1:]), 1e-9)
                           for r in reports},
                       tokens=pe0["tokens"][:2].tolist())
        else:
            for what in ("loss", "prefill"):
                rec = pe0[f"{what}_runs"][-1]
                w0, wmax = _walls(reports, f"{what}_runs")
                row[f"{what}_forward"] = dict(
                    ms=w0, ms_slowest_pe=wmax,
                    collectives=rec["collectives"],
                    heap_bytes_per_pe=rec["heap_bytes"],
                    barrier_wait_share={r["pe"]: r[f"{what}_runs"][-1][
                        "wait_s"] / max(r[f"{what}_runs"][-1]["wall_s"],
                                        1e-9) for r in reports},
                    cannon_mm_by_variant=rec["launches"].get(
                        "matmul_cuda", {}).get("by_variant"))
            row.update(loss=pe0["loss"], loss_1x1=one[label]["loss"],
                       n_tokens=pe0["n_tokens"])
            if cfg.compute_dtype == torch.float32:
                fp32_results.setdefault(label, {})[s] = reports
        emit("grid_forward_run", **row, nvidia_smi=smi)
        rows.append(row)
    # the fp32 strategies against each other, on every PE
    for label, by_s in fp32_results.items():
        base = by_s["cannon"]
        for s, reports in by_s.items():
            for r, b in zip(reports, base):
                e_loss = abs(r["loss"] - b["loss"]) / abs(b["loss"])
                e_log = rel_err(torch.from_numpy(b["logits"]),
                                torch.from_numpy(r["logits"]))
                if max(e_loss, e_log) > GRID_FWD_TOL:
                    failed.append(f"grid_forward {label}: {s} PE {r['pe']} "
                                  f"{e_loss} / {e_log} from cannon's")
    train_failed, train_rows, train_by_path = grid_train_rows(
        train_table, train_runs, one_train, plan, smi)
    failed += train_failed
    for name, paths in train_by_path.items():
        by_path.setdefault(name, {}).update(paths)
    emit("grid_train", rows=[{k: r[k] for k in (
        "run", "strategy", "layers", "state_bits", "both_clip", "losses",
        "losses_1x1", "grad_norms", "grad_norms_1x1", "ms_per_step",
        "ms_per_step_slowest_pe", "ms_per_step_1x1", "collectives_per_step",
        "heap_mb_per_pe_per_step", "heap_mb_per_pe", "barrier_wait_share",
        "params_spread_1x1")}
        for r in train_rows], nvidia_smi=smi)
    check(not failed, "; ".join(failed[:12]))
    phase_s = prep["prep_s"] + spawn_s + time.perf_counter() - t0
    emit("grid_forward", jobs=[f"{label} {s}" for label, s in keys],
         one_device_s=prep["one_s"], grid_spawn_and_run_s=spawn_s,
         pe_start_s=pe_start_s, pe_end_s=end_s,
         jobs_s=sum(max(r["job_s"] for r in reports) for reports in runs),
         phase_s=phase_s, nvidia_smi=smi)
    check(phase_s < GRID_FWD_PHASE_S,
          f"the grid_forward phase took {phase_s:.0f} s")
    return (by_path, rows), phase_s


def phase_grids(smi):
    """The grid and grid_forward phases (``grid_prepare``,
    ``grid_forward_prepare``) in one spawn of the 2x2 grid of PE processes
    (``launch/grid_run.py::run_on_grid``, which serves the engine's jobs
    as ``serve_on_grid`` does), so the PEs start once: the collective's
    parts timed, the serving jobs, then the forward, decode and training
    jobs.  Each phase's seconds are its own work before and after the
    spawn and its share of the spawn: the PEs' start and the serving jobs
    to the grid phase, the rest to grid_forward.  Returns both phases'
    results."""
    from repro_torch.core.pe_grid import probe_latency
    from repro_torch.launch.grid_run import ProbeJob, run_on_grid
    gc.collect()
    torch.cuda.empty_cache()
    serve = grid_prepare()
    gc.collect()
    torch.cuda.empty_cache()
    fwd = grid_forward_prepare()
    jobs = [ProbeJob(probe_latency)] + serve["jobs"] + fwd["jobs"]
    t_grid, t_wall = time.perf_counter(), time.time()
    runs = run_on_grid(jobs, serve["plan"], device=DEV, timeout=900)
    grid_s = time.perf_counter() - t_grid
    shutil.rmtree(ROOT / "build" / "grid_train", ignore_errors=True)
    # the PEs' start (spawn to the target) and end (the target's return
    # to the results in hand), on the wall clock all processes share
    pe_start_s = max(r["t_enter"] for r in runs[0]) - t_wall
    end_s = t_wall + grid_s - min(r["t_leave"] for r in runs[0])
    n = 1 + len(serve["jobs"])
    serve_s = pe_start_s + sum(max(r["job_s"] for r in reports)
                               for reports in runs[:n])
    out, seconds = {}, {}
    out["grid"], seconds["grid"] = grid_check(
        smi, serve, runs[1:n], [r["result"] for r in runs[0]], serve_s)
    out["grid_forward"], seconds["grid_forward"] = grid_forward_check(
        smi, fwd, runs[n:], grid_s - serve_s, pe_start_s, end_s)
    for name, sec in seconds.items():
        PHASE_SECONDS[name] = round(sec, 1)
        emit("seconds", of=name, seconds=PHASE_SECONDS[name])
    return out["grid"], out["grid_forward"]


# ---------------------------------------------------------------------------
# The training step on the grid (grid_train): jobs in grid_forward's spawn.
# ---------------------------------------------------------------------------

# two AdamW steps of each job on one batch of GRID_FWD_BATCH x GRID_FWD_SEQ
# tokens (512 a grid row), the layer groups recomputed in the backward
GRID_TRAIN_STEPS = 2
GRID_TRAIN_OPT = dict(lr=1e-3, eps=1e-6, warmup_steps=2, decay_steps=10)
GRID_TRAIN_MAMBA_LAYERS = 8          # of mamba2-780m's 48
GRID_TRAIN_MOE_LAYERS = 2            # of qwen3-moe's 94, bf16, 8-bit moments
# fp32 against the port's 1x1 on the same weights and batch: the CPU
# tests' bounds against JAX (the loss rel 1e-5, grad_norm rel 1e-4 of q*r
# times the 1x1's, the parameter blocks after the last step within 2e-5)
GRID_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 2e-5}
# mamba2-780m's parameter blocks after the second step take this bound
# instead, 3x the 1x1's own spread between two fp32 routes of the same
# steps (its scan at chunk 128 against 64, ``params_spread_1x1`` of each
# run: 6.9e-5 on an H100); the grid reads 6.9e-5 to 7.8e-5 by PE.  The
# first loss drops 11.3 -> 8.9, and AdamW's first moment cancels where a
# gradient turns, which magnifies the rounding of another scan split
GRID_TRAIN_DEEP_PARAMS_TOL = {"mamba2-780m fp32": 2e-4}
# bf16 (qwen2-0.5b cannon_opt, qwen3-moe): the first step's grad_norm
# against q*r times the 1x1 bf16 run's and the second step's loss against
# its, relative: limits between the sound grid's reading and a control (a
# copy made on the chip machine whose all_gather backward keeps this PE's
# own chunk of the cotangent instead of the reduce-scatter), near their
# geometric means.  On an H100, sound / control: qwen2-0.5b grad_norm
# 5.75e-4 / 0.205, loss 2.52e-5 / 1.19e-3; qwen3-moe 1.42e-3 / 0.132,
# 1.66e-4 / 0.0416.  PERF.md has the readings.
GRID_TRAIN_BF16_TOL = {
    "qwen2-0.5b bf16": {"grad_norm": 0.01, "loss2": 1.7e-4},
    "qwen3-moe bf16": {"grad_norm": 0.014, "loss2": 2.6e-3}}


def grid_train_table():
    """The training jobs, as (label, config, strategy, state_bits, whether
    the parameter blocks are held against the 1x1's): qwen2-0.5b (24
    layers) in fp32 under cannon and cannon_opt and in bf16 under
    cannon_opt (the launcher's default), mamba2-780m at
    GRID_TRAIN_MAMBA_LAYERS layers in fp32 under cannon, qwen3-moe at
    GRID_TRAIN_MOE_LAYERS layers (capacity_factor GRID_MOE_CF: nothing
    drops) in bf16 with 8-bit moments under cannon_opt."""
    f32, b16 = torch.float32, torch.bfloat16
    qwen32 = grid_cfg("qwen2-0.5b", f32)
    return [("qwen2-0.5b fp32", qwen32, "cannon", 32, True),
            ("qwen2-0.5b fp32", qwen32, "cannon_opt", 32, True),
            ("qwen2-0.5b bf16", grid_cfg("qwen2-0.5b", b16), "cannon_opt",
             32, False),
            ("mamba2-780m fp32", grid_cfg(
                "mamba2-780m", f32, n_layers=GRID_TRAIN_MAMBA_LAYERS),
             "cannon", 32, True),
            ("qwen3-moe bf16", grid_cfg(
                "qwen3-moe-235b-a22b", b16,
                n_layers=GRID_TRAIN_MOE_LAYERS), "cannon_opt", 8, False)]


def train_ref_path(label, storage):
    """The file pattern (``{pe}`` the PE) of the 1x1 run's final blocks
    in ``storage``, in the checkout's build directory."""
    d = ROOT / "build" / "grid_train"
    d.mkdir(parents=True, exist_ok=True)
    tag = label.replace(" ", "_")
    return str(d / f"{tag}_{storage}_pe{{pe}}.pt")


def _one_device_steps(cfg, bits, batch):
    """GRID_TRAIN_STEPS steps of the port's 1x1 step (remat) from the
    seed-0 weights drawn on the card: (final parameters, each step's
    loss, grad_norm and wall)."""
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.step import make_train_step
    gen = torch.Generator(DEV).manual_seed(0)
    params = init_params(cfg, generator=gen, device=DEV)
    opt_cfg = AdamWConfig(**GRID_TRAIN_OPT, state_bits=bits)
    opt = init_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg=opt_cfg, remat=True)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for _ in range(GRID_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    return params, out


def one_device_train(label, cfg, bits, toks, labels, storages, plan):
    """The port's 1x1 step GRID_TRAIN_STEPS times on one batch
    (:func:`_one_device_steps`): each step's loss, grad_norm and wall;
    with ``storages`` the final parameters cut into every PE's blocks in
    each storage, saved for the PEs to hold theirs against
    (:func:`train_ref_path`).  For a label of GRID_TRAIN_DEEP_PARAMS_TOL
    also the 1x1's own spread: the same steps with the scan at half its
    chunk, the largest difference of the final blocks (``spread``), the
    measure that bound is set from."""
    from repro_torch.models.params import shard_params
    from repro_torch.tree import flatten_with_paths
    gc.collect()
    torch.cuda.empty_cache()
    batch = {"tokens": torch.from_numpy(toks).to(DEV),
             "labels": torch.from_numpy(labels).to(DEV)}
    params, out = _one_device_steps(cfg, bits, batch)
    other = None
    if label in GRID_TRAIN_DEEP_PARAMS_TOL:
        other, _ = _one_device_steps(dataclasses.replace(
            cfg, ssd_chunk=cfg.ssd_chunk // 2), bits, batch)
        out["spread"] = 0.0
    out["files"] = {}
    for storage in storages:
        path = train_ref_path(label, storage)
        for pe in range(plan.n_pes):
            ps, flat = flatten_with_paths(
                shard_params(params, cfg, plan, pe, storage=storage))
            torch.save({p: t.cpu() for p, t in zip(ps, flat)},
                       path.format(pe=pe))
            if other is not None:
                alt = flatten_with_paths(
                    shard_params(other, cfg, plan, pe, storage=storage))[1]
                out["spread"] = max([out["spread"]] + [
                    float((a - b).abs().max()) for a, b in zip(flat, alt)])
            del flat
        out["files"][storage] = path
    del params, other, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_train_launches(cfg, strategy, plan):
    """Launches a PE's training step implies: cannon_mm on every
    distributed GEMM of the forward, of the recompute (every layer group
    again) and of both backward products (dA, dB), q local products a
    Cannon, crot or SUMMA GEMM; per MoE layer the grouped GEMM's forward
    w1 (swiglu) twice (forward, recompute), w2 three times (forward,
    recompute, the swiglu backward's recomputed product), dgrad and wgrad
    twice each."""
    per_gemm = 1 if strategy == "allgather" else plan.grid_q
    fwd = grid_denses(cfg)
    n_moe = layer_counts(cfg)["moe"]
    return {"matmul_cuda": per_gemm * (3 * fwd + fwd - 1),
            "grouped_mm_swiglu_cuda": 2 * n_moe,
            "grouped_mm_cuda": 3 * n_moe,
            "grouped_mm_dgrad_cuda": 2 * n_moe,
            "grouped_mm_wgrad_cuda": 2 * n_moe}


def check_train_pe(where, label, cfg, strategy, r, one, plan, held):
    """One PE's training job: heap bytes and collectives of every step as
    ``train_messages`` reckons them, the launches of
    :func:`grid_train_launches` and no plain version on every step, every
    loss and grad norm finite; fp32 against the 1x1 (GRID_TRAIN_TOL):
    the first step's loss and grad_norm (q*r times the 1x1's) always,
    the second step's and the parameter blocks (mamba2's within
    GRID_TRAIN_DEEP_PARAMS_TOL) only where the 1x1's first grad norm
    exceeds grad_clip (then both clip, and the first update is the same;
    else the grid, whose gradients carry q*r, clips where the 1x1 does
    not); bf16 within GRID_TRAIN_BF16_TOL."""
    failed = []
    qr = plan.n_pes
    want = grid_train_launches(cfg, strategy, plan)
    for k, rec in enumerate(r["steps"]):
        n = {name: c["launches"] for name, c in rec["launches"].items()}
        if rec["heap_bytes"] != r["reckoned_heap_bytes"] \
                or rec["collectives"] != r["reckoned_collectives"]:
            failed.append(f"{where} step {k}: heap bytes {rec['heap_bytes']}"
                          f", {rec['collectives']} collectives; reckoned "
                          f"{r['reckoned_heap_bytes']}, "
                          f"{r['reckoned_collectives']}")
        plain = {name: v for name, v in n.items()
                 if name.endswith("_ref") and v}
        got = {name: n.get(name, 0) for name in want}
        if plain or got != want:
            failed.append(f"{where} step {k}: launches {got}, expected "
                          f"{want}; plain {plain}")
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            failed.append(f"{where} step {k}: loss {rec['loss']}, grad_norm "
                          f"{rec['grad_norm']}")
    if r["device"][:4] != "cuda" or r["heap"] != "CudaHeap":
        failed.append(f"{where}: {r['device']} with a {r['heap']}")
    s = r["steps"]
    both_clip = one["grad_norm"][0] > GRID_TRAIN_OPT.get("grad_clip", 1.0)
    errs = {"loss1_rel_err": abs(s[0]["loss"] - one["loss"][0])
            / abs(one["loss"][0]),
            "grad_norm1_rel_err": abs(s[0]["grad_norm"]
                                      - qr * one["grad_norm"][0])
            / (qr * one["grad_norm"][0]),
            "loss2_rel_err": abs(s[1]["loss"] - one["loss"][1])
            / abs(one["loss"][1]),
            "grad_norm2_rel_err": abs(s[1]["grad_norm"]
                                      - qr * one["grad_norm"][1])
            / (qr * one["grad_norm"][1])}
    if held:
        errs["params_max_abs_err"] = max(r["param_max_abs_err"].values())
    if cfg.compute_dtype == torch.float32:
        limits = {"loss1_rel_err": GRID_TRAIN_TOL["loss"],
                  "grad_norm1_rel_err": GRID_TRAIN_TOL["grad_norm"]}
        if both_clip:
            limits.update(loss2_rel_err=GRID_TRAIN_TOL["loss"],
                          grad_norm2_rel_err=GRID_TRAIN_TOL["grad_norm"])
            if held:
                limits["params_max_abs_err"] = \
                    GRID_TRAIN_DEEP_PARAMS_TOL.get(label,
                                                   GRID_TRAIN_TOL["params"])
        else:
            failed.append(f"{where}: the 1x1's first grad norm "
                          f"{one['grad_norm'][0]} does not exceed grad_clip:"
                          f" the second step is not comparable")
    else:
        tol = GRID_TRAIN_BF16_TOL[label]
        limits = {k: v for k, v in (("grad_norm1_rel_err", tol["grad_norm"]),
                                    ("loss2_rel_err", tol["loss2"]))
                  if v is not None}
    for k, lim in limits.items():
        if errs[k] > lim:
            failed.append(f"{where}: {k} {errs[k]} from the 1x1 (limit "
                          f"{lim})")
    return errs, both_clip, failed


def grid_train_rows(keys, runs, one, plan, smi):
    """Gate and print every training job (:func:`check_train_pe`) on every
    PE; returns (failures, rows, launches by path)."""
    failed, rows, by_path = [], [], {}
    for (label, cfg, strategy, bits, held), reports in zip(keys, runs):
        path = f"{label} {strategy} grid 2x2 (train step)"
        ref = one[label]
        row = dict(run=label, strategy=strategy, layers=cfg.n_layers,
                   state_bits=bits, heap_slot_bytes=reports[0][
                       "heap_slot_bytes"],
                   max_message_bytes=reports[0]["max_message_bytes"],
                   job_s=max(r["job_s"] for r in reports),
                   setup_s=max(r["setup_s"] for r in reports))
        for r in reports:
            where = f"grid_train {label} {strategy} PE {r['pe']}"
            errs, both_clip, bad = check_train_pe(
                where, label, cfg, strategy, r, ref, plan, held)
            failed += bad
            for k, v in errs.items():
                row.setdefault(k + "_by_pe", {})[r["pe"]] = v
            for rec in r["steps"]:
                for name, c in rec["launches"].items():
                    if not name.endswith("_cuda"):
                        continue
                    e = by_path.setdefault(name[:-len("_cuda")], {}
                                           ).setdefault(path, {
                                               "launches": 0,
                                               "by_variant": {}})
                    e["launches"] += c["launches"]
                    for v, m in c["by_variant"].items():
                        if m:
                            e["by_variant"][v] = e["by_variant"].get(v, 0) + m
        pe0 = reports[0]
        last = [r["steps"][-1] for r in reports]
        row.update(
            both_clip=both_clip, losses=[s["loss"] for s in pe0["steps"]],
            losses_1x1=ref["loss"],
            grad_norms=[s["grad_norm"] for s in pe0["steps"]],
            grad_norms_1x1=ref["grad_norm"],
            ms_per_step=[1e3 * s["wall_s"] for s in pe0["steps"]],
            ms_per_step_slowest_pe=max(1e3 * s["wall_s"] for s in last),
            ms_per_step_1x1=ref["ms"],
            params_spread_1x1=ref.get("spread"),
            collectives_per_step=pe0["steps"][-1]["collectives"],
            heap_mb_per_pe_per_step=pe0["steps"][-1]["heap_bytes"] / 1e6,
            heap_mb_per_pe=pe0["heap_mb"],
            barrier_wait_share={r["pe"]: r["steps"][-1]["wait_s"]
                                / max(r["steps"][-1]["wall_s"], 1e-9)
                                for r in reports},
            cannon_mm_by_variant=pe0["steps"][-1]["launches"].get(
                "matmul_cuda", {}).get("by_variant"))
        emit("grid_train_run", **row, nvidia_smi=smi)
        rows.append(row)
    return failed, rows, by_path


# ---------------------------------------------------------------------------
# The fresh-thread launches, the fixed-batch decode path, whisper and
# pixtral.
# ---------------------------------------------------------------------------

DECODE_BATCH, DECODE_S_MAX = 8, 512
# the fixed-batch modes each model runs: qwen2 all three (one function on
# one card, held identical), the others the JAX launcher's default
DECODE_MODES = {"qwen2-0.5b": ("gemv", "batched", "longctx"),
                "mamba2-780m": ("gemv",), "qwen3-moe-235b-a22b": ("gemv",)}


def phase_fresh_thread():
    """Each kernel library's first launch in a fresh process on a new
    thread (the grouped GEMM's also inside a backward, on the autograd
    engine's thread), against the main thread's bits
    (``repro_torch.launch.fresh_thread``, every case in a process of its
    own, all at once).  Gate: every case launches and gives the same
    bits."""
    from repro_torch.launch.fresh_thread import CASES, run_all
    t0 = time.perf_counter()
    rows = run_all(workers=len(CASES))
    bad = [r for r in rows if not r["ok"]]
    emit("fresh_thread", cases=rows, seconds=time.perf_counter() - t0)
    check(not bad, f"fresh_thread: first launches failed or differ: {bad}")


def fixed_decode(cfg, params, first, mode):
    """MAX_TOKENS greedy tokens of ``make_decode_step`` in ``mode`` from one
    first token per slot (B = len(first)), over a cache of DECODE_S_MAX
    positions.  Returns (tokens per slot, fp32 logits (B, n, V) on the
    host, wall ms per token synchronised with the card, the step, the
    cache and the last tokens, to run on)."""
    from repro_torch.models.params import stored_heads
    from repro_torch.serve.decode import cache_specs, make_decode_step
    B = len(first)
    step = make_decode_step(cfg, batch=B, s_max=DECODE_S_MAX, mode=mode)
    cache = cache_specs(cfg, B, DECODE_S_MAX, mode, device=DEV,
                        kvh=stored_heads(params, cfg)[1] or None)
    tok = torch.tensor(first, dtype=torch.int32, device=DEV)
    toks, rows = [], []
    n = MAX_TOKENS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits = step(params, cache, tok, t)[:, 0, :cfg.vocab_size]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        rows.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    tokens = torch.stack(toks, 1).cpu().tolist()
    rows = torch.stack(rows, 1).float().cpu().numpy()
    check(np.isfinite(rows).all(), f"{cfg.name} {mode}: non-finite logits")
    return tokens, rows, wall, step, cache, tok


def phase_decode_fixed(eng, arch, modes=("gemv",), engine_profile=None):
    """The fixed-batch decode path (``serve/decode.py::make_decode_step``)
    on the engine's weights: batch DECODE_BATCH, MAX_TOKENS greedy tokens
    from one first token per slot, in each of ``modes`` (gemv first: the
    JAX launcher's default).  Gates: the modes give identical tokens and
    logits within 1e-6 of the largest (one function on one card); the
    tokens equal the engine's on the same one-token prompts and weights up
    to near-ties (``hold_tokens``); the grouped GEMM launched twice per
    MoE layer and step (w1 fused, w2) on the gemv run, counted from 0 just
    before it, and no plain version.  Reported: the wall per token and the
    device busy time per step of the fixed path beside the engine's
    batch-8 decode step (``engine_profile``).  Returns the gemv run's
    kernel launches."""
    from repro_torch.serve.engine import SamplingParams
    cfg, params = eng.cfg, eng.params
    rng = np.random.default_rng(5)
    first = rng.integers(0, cfg.vocab_size, DECODE_BATCH).tolist()
    counters = zero_counts()
    tokens, rows, wall, step, cache, tok = fixed_decode(cfg, params, first,
                                                        modes[0])
    launches = {k: kern.launches for k, (kern, _) in counters.items()}
    plain = {k: pl.launches for k, (_, pl) in counters.items()}
    by_variant = {k: dict(kern.by_variant) for k, (kern, _) in
                  counters.items() if k.startswith("grouped_mm")}
    n_moe = cfg.n_groups() * [f for _, f in cfg.pattern()].count("moe")
    want = dict.fromkeys(counters, 0)
    want["grouped_mm"] = want["grouped_mm_swiglu"] = n_moe * MAX_TOKENS
    check(launches == want, f"{arch} decode_fixed: kernel launches "
                            f"{launches} != {want}")
    check(not any(plain.values()),
          f"{arch} decode_fixed: plain versions ran {plain}")
    busy = busy_ms(lambda i: step(params, cache, tok, MAX_TOKENS + i), 8)
    by_mode = {}
    for mode in modes[1:]:
        t2, r2, w2, _, _, _ = fixed_decode(cfg, params, first, mode)
        diff = float(np.abs(r2 - rows).max() / np.abs(rows).max())
        by_mode[mode] = dict(wall_ms_per_token=w2, tokens_equal=t2 == tokens,
                             logits_identical=bool(np.array_equal(r2, rows)),
                             logits_rel_diff=diff)
        check(t2 == tokens and diff <= 1e-6,
              f"{arch}: mode {mode} differs from {modes[0]}: {by_mode[mode]}")
    prompts = [[f] for f in first]
    outs, _, _, rec = serve_once(eng, prompts,
                                 SamplingParams(max_tokens=MAX_TOKENS),
                                 record=True)
    ref_rows = {(tuple(prompts[b]), i): rows[b, i]
                for b in range(DECODE_BATCH) for i in range(MAX_TOKENS)}
    held = hold_tokens(f"{arch} decode_fixed vs engine", prompts, tokens,
                       [c.tokens for c in outs], ref_rows, rec)
    check(drained(eng), f"{arch}: the engine kept pages or slots")
    emit("decode_fixed", config=cfg.name, n_layers=cfg.n_layers,
         batch=DECODE_BATCH, s_max=DECODE_S_MAX, tokens=MAX_TOKENS,
         modes=list(modes), wall_ms_per_token=wall,
         device_busy_ms_per_step=busy, other_modes=by_mode,
         kernel_launches=launches, plain_launches=plain,
         grouped_mm_by_variant=by_variant, against_engine=held,
         engine_decode_step={k: engine_profile[k] for k in (
             "step_wall_ms", "device_busy_ms", "device_idle_share")}
         if engine_profile else None,
         first_tokens=tokens[0][:8])
    return launches


def phase_encdec(smi):
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, d_model 512, vocab 51865, bf16), random weights from seed 0:
    the encoder over 1500 stub frames for batch 8, every decoder layer's
    cross K/V cached from it (``fill_cross_cache``), then MAX_TOKENS
    greedy tokens of the fixed-batch path (gemv).  Teacher forcing: the
    decode path's logits of the fed tokens against ``forward`` (and
    ``make_prefill``'s last position) on the same tokens and frames, in
    bf16 (reported; gated at 2^-3 of the largest logit, greedy agreeing
    up to near-ties) and on the weights widened to fp32 (gated at 1e-4).
    Then TRAIN_STEPS AdamW steps (``train_model``) on 8 x 448 tokens (the
    published decoder context) with their frames.  No kernel of the port
    runs on this path: attention is the plain one, as in the JAX decode
    path, and the model has no MoE.  Returns the training row."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import forward
    from repro_torch.serve.decode import (_last_logits, cache_specs,
                                          fill_cross_cache, make_decode_step,
                                          make_prefill)
    cfg = get_config("whisper-base")
    got = (cfg.n_layers, cfg.enc_layers, cfg.enc_seq, cfg.d_model,
           cfg.n_heads, cfg.d_ff, cfg.vocab_size, cfg.compute_dtype)
    check(got == (6, 6, 1500, 512, 8, 2048, 51865, torch.bfloat16),
          f"whisper-base is not at its full width: {got}")
    gen = torch.Generator(DEV).manual_seed(0)
    params = init_params(cfg, generator=gen, device=DEV)
    frames = torch.randn((DECODE_BATCH, cfg.enc_seq, cfg.d_model),
                         generator=gen, device=DEV)
    first = np.random.default_rng(6).integers(
        0, cfg.vocab_size, DECODE_BATCH).tolist()
    counters = zero_counts()
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        p = params if dtype == torch.bfloat16 else to_dtype(params, dtype)
        cache = cache_specs(c, DECODE_BATCH, DECODE_S_MAX, "gemv",
                            device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = fill_cross_cache(c, p, cache, frames)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(enc.shape) == (DECODE_BATCH, cfg.enc_seq, cfg.d_model)
              and bool(torch.isfinite(enc).all()),
              f"whisper {dtype}: encoder output {tuple(enc.shape)}")
        step = make_decode_step(c, batch=DECODE_BATCH, s_max=DECODE_S_MAX,
                                mode="gemv")
        tok = torch.tensor(first, dtype=torch.int32, device=DEV)
        fed, dec = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MAX_TOKENS):
            fed.append(tok)
            logits = step(p, cache, tok, t)[:, 0, :cfg.vocab_size]
            dec.append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / MAX_TOKENS
        fed = torch.stack(fed, 1)
        dec = torch.stack(dec, 1).float()
        with torch.no_grad():
            x, _ = forward(c, p, {"tokens": fed, "frames": frames})
            ref = _last_logits(p["lm_head"], x)[..., :cfg.vocab_size]
        last = make_prefill(c, extra_batch_keys=("frames",))(
            p, {"tokens": fed, "frames": frames})[:, 0, :cfg.vocab_size]
        scale = float(ref.abs().max())
        rel = float((dec - ref).abs().max()) / scale
        rel_last = float((last - ref[:, -1]).abs().max()) / scale
        ref_np, dec_np = ref.cpu().numpy(), dec.cpu().numpy()
        flips = []
        for b in range(DECODE_BATCH):
            for i in range(MAX_TOKENS):
                a, d = ref_np[b, i].argmax(), dec_np[b, i].argmax()
                if a != d:
                    row = ref_np[b, i]
                    top = np.partition(row, -2)[-2:]
                    flips.append(float((top[1] - top[0]) / row.std()))
        tol = 2.0 ** -3 if dtype == torch.bfloat16 else 1e-4
        rows[str(dtype)] = dict(encoder_ms=enc_ms, wall_ms_per_token=wall,
                                teacher_forced_rel_err=rel,
                                prefill_last_rel_err=rel_last,
                                greedy_flips=len(flips),
                                flip_margins=flips, tolerance=tol,
                                first_tokens=fed[0, 1:9].tolist())
        check(rel <= tol and rel_last <= tol,
              f"whisper {dtype}: teacher-forced decode against forward "
              f"{rel:.3g} (prefill {rel_last:.3g}) > {tol}")
        check(all(m < SPEC_MARGIN for m in flips),
              f"whisper {dtype}: greedy leaves forward's argmax away from "
              f"a near-tie: {flips}")
        del cache, enc, p
    plain = {k: pl.launches for k, (_, pl) in counters.items()}
    check(not any(plain.values()), f"whisper: plain versions ran {plain}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row, _ = train_model("whisper-base", None, 32, TRAIN_LR, True, smi,
                       seq=448, batch_size=DECODE_BATCH)
    emit("encdec", config=cfg.name, batch=DECODE_BATCH, frames=cfg.enc_seq,
         tokens=MAX_TOKENS, by_dtype=rows,
         train={k: row[k] for k in ("steady_step_ms", "tokens_per_s",
                                    "peak_gb", "losses")},
         nvidia_smi=smi)
    return row


# pixtral-12b's training run: the depth that fits one card with fp32
# AdamW moments (57.6 GB of state) beside a step's activations, and its
# 1024 patch positions in front of 1024 text tokens
VLM_TRAIN_LAYERS, VLM_TRAIN_SEQ, VLM_TRAIN_BATCH = 12, 2048, 2


def phase_vlm(smi):
    """pixtral-12b at full width, all 40 layers (d_model 5120, 32 q over 8
    kv heads, hd 160, vocab 131072; 25.6 GB of bf16 weights), random
    weights from seed 0: phase 6's engine workload on its text (paged
    attention at hd 160, group 4, on every attention layer of every
    launch; ``vis_proj`` unused, as in the JAX engine) and the profile
    phase, then ``make_prefill`` on batch 2 of 1024 stub patch
    embeddings in front of 512 text tokens (finite logits that the patches
    move), then a training run at VLM_TRAIN_LAYERS layers.  Returns
    (the engine's kernel launches, the training row)."""
    import torch.nn.functional as F
    from repro_torch.serve.decode import make_prefill
    arch = "pixtral-12b"
    gc.collect()
    torch.cuda.empty_cache()
    counts, eng, prompts, arrivals, sampling, outputs, _ = phase_engine(arch)
    phase_profile(eng, arrivals, sampling,
                  shares={"paged_attention": ("paged_",)})
    cfg, params = eng.cfg, eng.params
    gen = torch.Generator(DEV).manual_seed(1)
    P, T, B = cfg.vis_patches, 512, 2
    text = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=DEV, dtype=torch.int32)
    tokens = torch.cat([torch.full((B, P), -1, dtype=torch.int32,
                                   device=DEV), text], 1)
    patches = torch.randn((B, P, cfg.d_model), generator=gen, device=DEV)
    prefill = make_prefill(cfg, extra_batch_keys=("patches",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens, "patches": patches})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    bare = prefill(params, {"tokens": tokens,
                            "patches": torch.zeros_like(patches)})
    moved = float((F.softmax(logits.float(), -1)
                   - F.softmax(bare.float(), -1)).abs().sum(-1).max())
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"pixtral prefill logits {tuple(logits.shape)}")
    check(moved > 0, "pixtral prefill: the patches do not move the logits")
    emit("vlm_prefill", config=cfg.name, batch=B, patches=P, text=T,
         prefill_ms=prefill_ms, patch_effect_l1=moved,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del eng, params, logits, bare, patches
    gc.collect()
    torch.cuda.empty_cache()
    row, _ = train_model(arch, VLM_TRAIN_LAYERS, 32, TRAIN_LR, True, smi,
                       seq=VLM_TRAIN_SEQ, batch_size=VLM_TRAIN_BATCH)
    emit("vlm", config=cfg.name, engine_launches=counts,
         train={k: row[k] for k in ("layers", "steady_step_ms",
                                    "tokens_per_s", "peak_gb", "losses",
                                    "state_gb")}, nvidia_smi=smi)
    return counts, row


PHASE_SECONDS = {}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed and added to
    PHASE_SECONDS[name] (a phase called several times sums)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0)
                                + time.perf_counter() - t0, 1)
    emit("seconds", of=name, seconds=PHASE_SECONDS[name])
    return out


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
    t_start = T_START[0] = time.perf_counter()

    smi = timed("env", phase_env)
    timed("build", phase_build)
    timed("fresh_thread", phase_fresh_thread)
    worst = timed("kernel_vs_plain", phase_kernel_vs_plain)
    timing = timed("timing", phase_timing, n_layers=24)
    from repro_torch.configs import get_config
    dense_timing = {arch: timed(
        "timing", phase_timing, n_layers=get_config(arch).n_layers, Hq=Hq,
        kvh=kvh, hd=hd, geometry=arch)
        for arch, (Hq, kvh, hd) in DENSE_GEOMS.items()}
    ssd_worst = timed("ssd_vs_plain", phase_ssd_vs_plain)
    ssd_timing = timed("ssd_timing", phase_ssd_timing)
    mm_worst = timed("mm_vs_plain", phase_mm_vs_plain)
    mm_launches, mm_by_variant, cannon_worst, table1_live = timed(
        "cannon", phase_cannon)
    mm_timing = timed("mm_timing", phase_mm_timing)
    flash_worst = timed("flash_vs_plain", phase_flash_vs_plain)
    flash_launches, flash_timing = timed("flash_timing", phase_flash_timing)
    gmm_worst = timed("gmm_vs_plain", phase_gmm_vs_plain)
    gmm_timing = timed("gmm_timing", phase_gmm_timing)
    grad_worst = timed("gmm_grad_vs_plain", phase_gmm_grad_vs_plain)
    grad_timing = timed("gmm_grad_timing", phase_gmm_grad_timing)
    train_counts, train_by_run, train_rows, train_profile = timed(
        "train", phase_train, smi)
    resume_launches = timed("train_resume", phase_train_resume, smi)
    gc.collect()
    torch.cuda.empty_cache()
    new_paths = {**timed("dryrun", phase_dryrun, smi)}
    for k, paths in timed("examples", phase_examples).items():
        new_paths.setdefault(k, {}).update(paths)
    train_rows.append(timed("encdec", phase_encdec, smi))
    ref_launches = timed("reference", phase_reference)
    launches, by_path, weights = {}, {}, {}
    for arch in ("qwen2-0.5b", "mamba2-780m"):
        counts, eng, prompts, arrivals, sampling, outputs, _ = \
            timed("engine", phase_engine, arch)
        timed("graphs", phase_graphs, eng, prompts, arrivals, sampling,
              outputs)
        decode_profile = timed("profile", phase_profile, eng, arrivals,
                               sampling)
        if eng.store.has_dense:
            timed("prefill_profile", phase_prefill_profile, eng)
        timed("decode_fixed", phase_decode_fixed, eng, arch,
              DECODE_MODES[arch], decode_profile)
        params = eng.params
        del eng
        torch.cuda.empty_cache()
        spec_counts = timed("speculation", phase_speculation, arch, params)
        if arch == "mamba2-780m":
            # the same weights in fp32: verify and decode rows then differ
            # by the order of fp32 sums only (the bf16 run's differences
            # are the two paths' bf16 roundings)
            fp32 = timed("speculation", phase_speculation, arch,
                         to_dtype(params, torch.float32),
                         dtype=torch.float32, drafters=("replay",))
            for k, n in fp32.items():
                spec_counts[k] = spec_counts.get(k, 0) + n
        weights[arch] = params
        del params
        for path, got in (("engine", counts), ("speculation", spec_counts)):
            for k, n in got.items():
                if n:
                    launches[k] = launches.get(k, 0) + n
                    by_path.setdefault(k, {})[f"{arch} {path}"] = n
    # the service and the resilience layer on the same weights
    paths = {"qwen2-0.5b service": timed("service", phase_service,
                                         weights["qwen2-0.5b"])}
    for arch in ("qwen2-0.5b", "mamba2-780m"):
        paths[f"{arch} resilience"] = timed("resilience", phase_resilience,
                                            arch, weights[arch])
    for path, got in paths.items():
        for k, n in got.items():
            if n:
                launches[k] = launches.get(k, 0) + n
                by_path.setdefault(k, {})[path] = n
    del weights
    # the dense configs at full width, on an emptied cache, then the
    # replica supervisor (the parent holds no engine while workers run)
    dense_runs = timed("dense_wide", phase_dense_wide)
    dense_runs["pixtral-12b"], vlm_train = timed("vlm", phase_vlm, smi)
    train_rows.append(vlm_train)
    for arch, got in dense_runs.items():
        for k, n in got.items():
            if n:
                launches[k] = launches.get(k, 0) + n
                by_path.setdefault(k, {})[f"{arch} engine"] = n
    for path, got in timed("supervisor", phase_supervisor).items():
        for k, n in got.items():
            if n:
                launches[k] = launches.get(k, 0) + n
                by_path.setdefault(k, {})[path] = n
    # every decoder family on a 2x2 grid of PE processes, then the blocked
    # forward under the four strategies, the batched decode and the
    # training step there: one spawn, on an emptied cache
    (grid_launches, heap_rows, heap_err), (fwd_by_path, fwd_rows) = \
        phase_grids(smi)
    heap_by_path = {}
    for label, got in grid_launches.items():
        for k, n in got.items():
            if not k.endswith("_cuda"):
                continue
            name, path = k[:-len("_cuda")], f"{label} grid 2x2 (4 PEs)"
            if name.startswith("shmem_"):
                heap_by_path.setdefault(name, {})[path] = n
            else:
                launches[name] = launches.get(name, 0) + n
                by_path.setdefault(name, {})[path] = n
    mm_grid = fwd_by_path.pop("matmul", {})
    for name, paths in fwd_by_path.items():
        for path, got in paths.items():
            if name.startswith("shmem_"):
                heap_by_path.setdefault(name, {})[path] = got["launches"]
            elif name in ("ssd_chunk", "ssd_apply") \
                    and "mma" in got["by_variant"]:
                continue            # the passes' mma entry, below
            else:
                launches[name] = launches.get(name, 0) + got["launches"]
                by_path.setdefault(name, {})[path] = got["launches"]
    ssd_mma = {name: {path: got["launches"] for path, got in
                      fwd_by_path.get(name, {}).items()
                      if "mma" in got["by_variant"]}
               for name in ("ssd_chunk", "ssd_apply")}
    emit("grid_forward_summary", rows=[{k: r[k] for k in r if k in (
        "run", "strategy", "loss_forward", "prefill_forward",
        "ms_per_decode_step",
        "collectives_per_step", "heap_bytes_per_pe_per_step")}
        for r in fwd_rows], nvidia_smi=smi)
    # the MoE model last, on an emptied cache: 41.7 GB of weights
    gc.collect()
    torch.cuda.empty_cache()
    arch = "qwen3-moe-235b-a22b"
    counts, eng, prompts, arrivals, sampling, outputs, moe_routes_ = \
        timed("engine", phase_engine, arch)
    timed("graphs", phase_graphs, eng, prompts, arrivals, sampling, outputs)
    moe_shares = {"grouped_mm": ("gmm_",),
                  "grouped_mm wgmma_tma": ("gmm_wgmma_tma",),
                  "paged_attention": ("paged_",)}
    decode_profile = timed("profile", phase_profile, eng, arrivals,
                           sampling, shares=moe_shares)
    timed("prefill_profile", phase_prefill_profile, eng, moe_shares)
    fixed = timed("decode_fixed", phase_decode_fixed, eng, arch,
                  DECODE_MODES[arch], decode_profile)
    for path, got in ((f"{arch} engine", counts),
                      (f"{arch} decode_fixed", fixed)):
        for k, n in got.items():
            if n:
                launches[k] = launches.get(k, 0) + n
                by_path.setdefault(k, {})[path] = n
    del eng
    torch.cuda.empty_cache()
    for k, n in train_counts.items():
        if n:
            launches[k] = launches.get(k, 0) + n
            by_path.setdefault(k, {}).update(train_by_run[k])

    # the dry run's verified cells and the examples (new_paths)
    for k, paths in new_paths.items():
        if k == "cannon_mm":
            continue
        launches[k] = launches.get(k, 0) + sum(paths.values())
        by_path.setdefault(k, {}).update(paths)
    mm_by_path = {"cannon": mm_launches, **new_paths.get("cannon_mm", {}),
                  **{path: got["launches"] for path, got in mm_grid.items()}}
    # the grid launcher's fault drill (train_resume): its three runs
    resume_path = ("qwen2-0.5b bf16 cannon_opt grid 2x2 (launch/train.py "
                   "straight, drill and resumed runs)")
    mm_by_path[resume_path] = resume_launches["matmul_cuda"]
    for name in ("shmem_put", "shmem_reduce_slots"):
        heap_by_path.setdefault(name, {})[resume_path] = \
            resume_launches[f"{name}_cuda"]

    decode = timing[0]
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["paged_attention"],
        "launches_by_path": by_path["paged_attention"],
        "max_abs_err": decode["max_abs_err"],
        "max_rel_err": max(w[0] for w in worst.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"], "device_ms": decode["device_ms"],
        "n_split": decode["n_split"],
        "shape": "decode: B=8, L=1, Hq=14, kvh=2, hd=64, stride=16, bf16",
        "per_L": {str(t["L"]): {k: t[k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "n_split")} for t in timing},
        "per_geometry": {
            f"{arch}: Hq={Hq}, kvh={kvh}, hd={hd}": {
                str(t["L"]): {k: t[k] for k in (
                    "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "n_split", "max_rel_err")}
                for t in dense_timing[arch]}
            for arch, (Hq, kvh, hd) in DENSE_GEOMS.items()},
    }]
    # the fused scan (mma) carries mamba2's main path; the two passes carry
    # the fp32 reference configs on their simt variant, whose launches,
    # times and errors they report.  The passes' mma variant runs on no
    # driven path: its bf16 times stand apart under "mma".
    def ssd_entry(name, variant, rows, launches_, launches_from):
        top = rows[-1]
        return {
            "name": name, "variant": variant, "route": "cuda",
            "source": SSD_SOURCE, "replaces": SSD_REPLACES[name],
            "launches": launches_, "launches_from": launches_from,
            "max_abs_err": ssd_worst[f"{name}/{variant}"][1],
            "max_rel_err": ssd_worst[f"{name}/{variant}"][0],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "device_ms": top["device_ms"],
            "shape": (f"B={top['B']}, L={top['L']}, " + ", ".join(
                f"{k}={v}" for k, v in top["geometry"].items())
                + f", {top['dtype']} x"),
            "per_L_ms": {str(t["L"]): t["ms"] for t in rows},
            "per_L_device_ms": {str(t["L"]): t["device_ms"] for t in rows}}

    def ssd_rows(name, variant):
        return [t for t in ssd_timing
                if t["kernel"] == name and t["variant"] == variant]

    kernels.append(ssd_entry("ssd_scan_fused", "mma",
                             ssd_rows("ssd_scan_fused", "mma"),
                             launches["ssd_scan_fused"],
                             "engine, speculation and resilience "
                             "(mamba2-780m)"))
    kernels[-1]["launches_by_path"] = by_path["ssd_scan_fused"]
    for name in ("ssd_chunk", "ssd_apply"):
        entry = ssd_entry(name, "simt", ssd_rows(name, "simt"),
                          ref_launches[name] + launches.get(name, 0),
                          "reference (fp32 reduced mamba2 and hybrid), "
                          "speculation and resilience (mamba2-780m in "
                          "fp32), the sequence-sharded mamba block in fp32 "
                          "(grid_forward)")
        entry["launches_by_path"] = {"reference": ref_launches[name],
                                     **by_path.get(name, {})}
        mma = ssd_entry(name, "mma", ssd_rows(name, "mma"),
                        sum(ssd_mma[name].values()),
                        "the sequence-sharded mamba block in bf16 "
                        "(mamba2-780m, 4 chunks a grid row)")
        entry["mma"] = {k: mma[k] for k in (
            "launches", "launches_from", "max_abs_err", "max_rel_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "device_ms", "shape",
            "per_L_ms", "per_L_device_ms")}
        entry["mma"]["launches_by_path"] = ssd_mma[name]
        kernels.append(entry)
    top = mm_timing[2]                # the n = 8192 Cannon round
    kernels.append({
        "name": "cannon_mm", "route": "cuda", "source": MM_SOURCE,
        "replaces": MM_REPLACES, "launches": sum(mm_by_path.values()),
        "launches_by_path": mm_by_path, "by_variant": mm_by_variant,
        "by_variant_by_path": {path: got["by_variant"]
                               for path, got in mm_grid.items()},
        "max_abs_err": mm_worst[1], "max_rel_err": mm_worst[0],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "device_ms": top["device_ms"],
        "shape": top["shape"],
        "cannon_vs_fp64_rel_err": cannon_worst,
        "per_shape": {t["shape"]: {k: t[k] for k in (
            "variant", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")} for t in mm_timing},
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
    # grouped_mm carries w2 on the main path, grouped_mm_swiglu w1 with its
    # epilogue; each entry's headline is its len256 row, the chunk where
    # the wgmma_tma variant was built to serve
    for name, replaces in (("grouped_mm", GMM_REPLACES),
                           ("grouped_mm_swiglu", GMM_SWIGLU_REPLACES)):
        rows = [t for t in gmm_timing if t["fn"] == name]
        top = next(t for t in rows if t["shape"] == GMM_HEADLINE[name])
        errs = [e for (fn, _), e in gmm_worst.items() if fn == name]
        kernels.append({
            "name": name, "variant": top["variant"], "route": "cuda",
            "source": GMM_SOURCE, "replaces": replaces,
            "replaces_note": "lax.ragged_dot, an XLA op and not a Pallas "
                             "kernel",
            "launches": launches[name],
            "launches_by_path": {**by_path[name],
                                 "reference (fp32, simt)":
                                     ref_launches[name]},
            "by_variant": {f"{arch} engine": moe_routes_[name]["by_variant"],
                           "reference (fp32)": {"simt": ref_launches[name]}},
            "by_step": {f"{arch} engine": moe_routes_[name]["by_step"]},
            "plain_launches": {f"{arch} engine":
                               moe_routes_[name]["plain_launches"]},
            "max_abs_err": max(e[1] for e in errs),
            "max_rel_err": max(e[0] for e in errs),
            "max_rel_err_by_variant": {v: e[0] for (fn, v), e
                                       in gmm_worst.items() if fn == name},
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "library": top["library"],
            "device_ms": top["device_ms"],
            "shape": (f"{top['shape']}: M={top['M']}, K={top['K']}, "
                      f"N={top['N']}, E={top['E']}, {top['active_experts']} "
                      f"experts active, {top['dtype']}"),
            "per_shape": {f"{t['shape']} {t['dtype']}": {k: t.get(k) for k in (
                "variant", "ms", "device_ms", "plain_ms", "library_ms",
                "library_plus_glue_ms", "unfused_ms", "unfused_busy_ms",
                "bound_ms", "bound_by", "active_experts", "by_variant")}
                for t in rows},
        })
    # the backward products: launched on the MoE training path only; the
    # headline is the training step's w1 product (bf16, uniform routing)
    for kind in ("dgrad", "wgrad"):
        name = f"grouped_mm_{kind}"
        rows = [t for t in grad_timing if t["fn"] == name]
        top = next(t for t in rows if t["shape"] == "w1 train")
        kernels.append({
            "name": name, "variant": top["variant"], "route": "cuda",
            "source": GMM_SOURCE, "replaces": GMM_GRAD_REPLACES,
            "replaces_note": "the transpose JAX's autodiff makes of "
                             "lax.ragged_dot, an XLA op and not a Pallas "
                             "kernel",
            "launches": launches[name],
            "launches_by_path": by_path[name],
            "by_variant": {r["run"]: r["by_variant"][name]
                           for r in train_rows if r["launches"][name]},
            "plain_launches": {r["run"]: r["plain_launches"][name]
                               for r in train_rows},
            "max_abs_err": grad_worst[name][1],
            "max_rel_err": grad_worst[name][0],
            "swiglu_backward_max_rel_err":
                grad_worst["grouped_mm_swiglu backward"][0],
            "train_step_share": train_profile["kernel_shares"][
                f"grouped_mm {kind}"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "library": top["library"],
            "device_ms": top["device_ms"],
            "shape": (f"{top['shape']}: M={top['M']}, K={top['K']}, "
                      f"N={top['N']}, E={top['E']}, {top['active_experts']} "
                      f"experts active, {top['dtype']}"),
            "per_shape": {f"{t['shape']} {t['dtype']}": {k: t[k] for k in (
                "variant", "ms", "device_ms", "plain_ms", "library_ms",
                "library", "bound_ms", "bound_by", "rows", "active_experts")}
                for t in rows},
        })
    # the heap's kernels: the grid path's puts and reductions, every PE
    for name in ("shmem_put", "shmem_reduce_slots"):
        rows = [t for t in heap_rows if t["kernel"] == name]
        top = next(t for t in rows if t["shape"] == "len256")
        kernels.append({
            "name": name, "route": "cuda", "source": HEAP_SOURCE,
            "replaces": HEAP_REPLACES[name],
            "replaces_note": "XLA's collective-permute (put) and grouped "
                             "all-reduce (psum/pmax), not Pallas kernels",
            "launches": sum(heap_by_path[name].values()),
            "launches_by_path": heap_by_path[name],
            "max_abs_err": heap_err[name],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": ("Tensor.copy_" if name == "shmem_put"
                        else "torch.sum over the stacked slots"),
            "shape": f"len256: {HEAP_SHAPES['len256']} fp32"
                     + (", 2 slots" if name != "shmem_put" else ""),
            "device_ms": top["device_ms"],
            "library_device_ms": top["library_device_ms"],
            "per_shape": {t["shape"]: {k: t[k] for k in (
                "bytes", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms")} for t in rows}})
    emit("profiler_records", lead_in=PROFILE_LEAD_IN,
         windows=len(PROFILE_WINDOWS),
         windows_that_lost_work=sum(not k for _, _, k in PROFILE_WINDOWS),
         lead_in_lost_max=max(n for _, n, _ in PROFILE_WINDOWS),
         by_window=PROFILE_WINDOWS)
    emit("train_summary", rows=[{k: r[k] for k in (
        "run", "steady_step_ms", "tokens_per_s", "peak_gb", "losses",
        "nvidia_smi")} for r in train_rows],
         profile={k: train_profile[k] for k in (
             "run", "step_wall_ms", "device_busy_ms", "device_idle_share",
             "kernel_shares")})
    emit("table1_summary", rows=[{k: r[k] for k in (
        "size", "hybrid_ms", "opencl_ms", "hybrid_wire_bytes",
        "opencl_wire_bytes", "bytes_ratio")} for r in table1_live])
    emit("phase_seconds", **PHASE_SECONDS)
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        traceback.print_exc()
        print(f"chip_smoke: failed after phase {LAST_PHASE[0]!r} had "
              f"reported", file=sys.stderr)
        rc = 1
    sys.exit(rc)
