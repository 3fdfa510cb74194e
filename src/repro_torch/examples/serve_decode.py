"""Batched serving example: greedy decode of a fixed batch in the two
decode modes, then the continuous-batching engine on the same model.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
      --config mamba2-780m            # that arch's reduced config, engine

The counterpart of the JAX package's ``examples/serve_decode.py``.  The
fixed-batch step (``serve/decode.py::make_decode_step``) runs in
``batched`` and ``gemv`` mode; on one card the two are one function, so
the same seed gives the same tokens in both (on the JAX grid they store
the weights in different skews).  The engine then serves mixed-length
prompts through the command queue (one captured step per batch bucket and
chunk length on the card, paged KV, the ``paged_attention`` kernel),
chunked prefill included, and streams one request.  With ``--config
<arch>`` it serves that architecture's ``reduced()`` config through the
engine instead (SSM and hybrid families keep dense per-slot state beside
the paged KV).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params
from repro_torch.serve.decode import cache_specs, make_decode_step
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)


def engine_config(s_max: int, device) -> EngineConfig:
    return EngineConfig(s_max=s_max, buckets=(1, 2, 4), block_pos_stride=16,
                        device=str(device))


def prompts_for(vocab: int, n: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 9))).tolist()
            for _ in range(n)]


def serve_config(arch: str, device) -> Dict:
    """Engine smoke on a registry architecture (SSM / hybrid included)."""
    smoke = reduced(get_config(arch.replace("_", "-")))
    eng = build_engine(smoke, engine_cfg=engine_config(64, device), seed=0)
    prompts = prompts_for(min(smoke.vocab_size, 256), 4)
    outs = generate(eng, prompts, SamplingParams(max_tokens=8))
    for c in outs:
        print(f"{smoke.name} {c.request_id}: prompt[{len(c.prompt)}] -> "
              f"{c.tokens} ({c.finish_reason})")
    st = eng.state_specs
    print(f"{smoke.name} ({smoke.family}): paged state {st.has_paged}, "
          f"dense state {st.has_dense}, {eng.stats.tokens_generated} tokens, "
          f"{eng.queue.n_executables} executables, "
          f"peak state bytes {eng.peak_kv_bytes()}")
    return {"config": smoke, "prompts": prompts, "engine": outs}


def fixed_batch(cfg: ModelConfig, params, mode: str, B: int, s_max: int,
                n_tok: int, dev) -> np.ndarray:
    """Greedy decode of B slots from one random token each; prints the
    time per token and returns the tokens (B, n_tok + 1)."""
    step = make_decode_step(cfg, batch=B, s_max=s_max, mode=mode)
    cache = cache_specs(cfg, B, s_max, mode, device=dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B,))).to(dev)
    seq = [tok.cpu().numpy()]
    t0 = None
    for t in range(n_tok):
        logits = step(params, cache, tok, t)
        if t == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        tok = torch.argmax(logits[:, 0, :cfg.vocab_size], -1)
        seq.append(tok.cpu().numpy())
    dt = (time.perf_counter() - t0) / max(n_tok - 1, 1) * 1e3
    seq = np.stack(seq, 1)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "host CPU"
    print(f"mode={mode:8s} {dt:7.1f} ms/token ({where})  "
          f"first seq: {seq[0][:10].tolist()}")
    return seq


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None,
                    help="registry arch for an engine smoke run (reduced "
                         "config), e.g. mamba2-780m; underscores accepted")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--requests", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.config:
        return serve_config(args.config, dev)

    D = args.d_model
    cfg = ModelConfig(name="srv", family="dense", d_model=D,
                      n_layers=args.layers, n_heads=8, n_kv_heads=4,
                      d_ff=4 * D, vocab_size=args.vocab,
                      param_dtype=torch.float32, compute_dtype=torch.float32,
                      attn_block_kv=64)
    params = init_params(cfg, generator=torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    seqs = {mode: fixed_batch(cfg, params, mode, args.batch, args.s_max,
                              args.tokens, dev)
            for mode in ("batched", "gemv")}
    same = np.array_equal(seqs["batched"], seqs["gemv"])
    print(f"the two modes give {'the same' if same else 'different'} tokens "
          f"(one function on one card)")

    # --- continuous-batching engine on the same model ---------------------
    # mixed-length prompts through the CommandQueue: one step per batch
    # bucket and chunk length, per-slot positions, paged-KV admission
    eng = build_engine(cfg, engine_cfg=engine_config(args.s_max, dev),
                       params=params)
    prompts = prompts_for(cfg.vocab_size, args.requests)
    outs = generate(eng, prompts, SamplingParams(max_tokens=8))
    for c in outs[:3]:
        print(f"engine {c.request_id}: prompt[{len(c.prompt)}] -> {c.tokens}")
    print(f"engine: {eng.stats.tokens_generated} tokens, "
          f"{eng.queue.n_executables} executables "
          f"(steps {sorted(eng.kernel_events())}), "
          f"{eng.throughput_tok_s():.1f} tok/s from KernelEvent stats")
    print(f"engine: chunked prefill ingested "
          f"{eng.stats.prompt_tokens_ingested} prompt tokens in "
          f"{eng.stats.prefill_launches} launches "
          f"({eng.stats.prefill_chunk_launches} chunked)")

    # streaming front-end: tokens arrive as they are sampled
    print("engine stream:", end=" ", flush=True)
    streamed = []
    for tok in eng.stream(prompts[0], SamplingParams(max_tokens=6)):
        streamed.append(tok)
        print(tok, end=" ", flush=True)
    print()
    return {"config": cfg, "params": params, "fixed": seqs,
            "prompts": prompts, "engine": outs, "stream": streamed}


if __name__ == "__main__":
    main()
