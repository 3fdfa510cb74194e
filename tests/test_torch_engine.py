"""repro_torch serving engine against the JAX engine on the same weights.

Each JAX engine runs on the 4x4 grid (``mesh16``/``plan16``, seed 0); the
port's engine gets the same global weights through ``from_jax_params`` and
runs on the CPU with the plain version of every kernel.  The host logic
(scheduler, block pool, radix cache, request state machine) is a copy, so
greedy tokens and every ``EngineStats`` counter must be identical — not
close.  The logits behind the greedy choice agree to rel 1e-4
(tests/test_torch_decode.py).
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import EngineStats as JEngineStats
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                      SamplingParams, build_engine, generate)

# the tests/test_engine_generate.py config
JCFG = JModelConfig(name="eng", family="dense", d_model=64, n_layers=2,
                    n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                    param_dtype=jnp.float32, compute_dtype=jnp.float32,
                    attn_block_kv=32)
S_MAX = 32
STATS = ("steps", "prefill_launches", "prefill_chunk_launches",
         "decode_launches", "prompt_tokens_ingested", "tokens_generated",
         "migrations", "peak_blocks_used", "prefix_hits",
         "prefix_tokens_reused", "prefix_evictions")


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _pair(mesh, plan, jcfg=JCFG, **ec_kw):
    """A JAX engine (seed 0) and a CPU port engine on its weights."""
    jeng = j_build_engine(jcfg, mesh, plan, seed=0,
                          engine_cfg=JEngineConfig(**ec_kw))
    gp = jax.tree.map(np.asarray,
                      gather_params(jeng.params, jeng.specs, 4, 4))
    tcfg = torch_config(jcfg)
    teng = build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                        engine_cfg=EngineConfig(device="cpu", **ec_kw))
    return jeng, teng


def _stats(eng):
    return {k: getattr(eng.stats, k) for k in STATS}


def test_greedy_tokens_match_jax_engine(mesh16, plan16):
    """tests/test_engine_generate.py:66 — four 5-token prompts, 8 tokens,
    buckets (1, 2, 4), stride 4."""
    jeng, teng = _pair(mesh16, plan16, s_max=S_MAX, buckets=(1, 2, 4),
                       block_pos_stride=4)
    prompts = np.random.default_rng(0).integers(
        0, JCFG.vocab_size, size=(4, 5)).tolist()
    jo = j_generate(jeng, prompts, JSamplingParams(max_tokens=8))
    to = generate(teng, prompts, SamplingParams(max_tokens=8))
    for a, b in zip(jo, to):
        assert b.tokens == a.tokens
        assert b.finish_reason == a.finish_reason == "length"
    assert _stats(teng) == _stats(jeng)


def test_mixed_workload_matches_jax_engine(mesh16, plan16):
    """tests/test_engine_generate.py:81 — 16 mixed requests over buckets
    (1, 2, 4, 8): identical tokens and counters, and one step name per
    (bucket, chunk length) actually used."""
    jeng, teng = _pair(mesh16, plan16, s_max=S_MAX, buckets=(1, 2, 4, 8),
                       block_pos_stride=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, JCFG.vocab_size,
                            size=int(rng.integers(2, 10))).tolist()
               for _ in range(16)]
    mt = [int(rng.integers(3, 8)) for _ in range(16)]
    jo = j_generate(jeng, prompts, [JSamplingParams(max_tokens=m)
                                    for m in mt])
    to = generate(teng, prompts, [SamplingParams(max_tokens=m) for m in mt])
    assert [c.tokens for c in to] == [c.tokens for c in jo]
    assert _stats(teng) == _stats(jeng)
    assert teng.stats.migrations > 0 and teng.stats.prefill_chunk_launches > 0
    assert teng.queue.n_executables == len(teng.kernel_events())
    assert set(teng.kernel_events()) == set(jeng.kernel_events())
    assert teng.peak_kv_bytes() == jeng.peak_kv_bytes()
    assert teng.throughput_tok_s() > 0.0


def test_prompt_ingests_in_ceil_p_over_l_launches():
    """tests/test_prefill_chunked.py:63 — a P-token prompt reaches its first
    sampled token in ceil(P / L) launches, not P."""
    P, L = 33, 16
    eng = build_engine(torch_config(JCFG), seed=0, engine_cfg=EngineConfig(
        s_max=48, buckets=(1,), block_pos_stride=4, prefill_chunks=(L,),
        device="cpu"))
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, size=P).tolist()
    req = eng.submit(prompt, SamplingParams(max_tokens=2))
    launches = 0
    while not req.output_tokens:
        assert eng.step()
        launches += 1
    assert launches == -(-P // L) == 3
    assert eng.stats.prompt_tokens_ingested == P
    assert eng.stats.prefill_launches == launches


def test_shared_prefix_workload_matches_jax_engine(mesh16, plan16):
    """Shaped like benchmarks/serve_throughput.py::run_prefix (smoke size):
    every prompt is a 16-token shared prefix plus an 8-token tail, served
    twice; the second pass adopts the cached prefix pages.  Hits, hit rate
    and prefill launches must equal the JAX engine's."""
    kw = dict(s_max=64, buckets=(1, 2, 4, 8), block_pos_stride=8)
    jeng, teng = _pair(mesh16, plan16, **kw)
    rng = np.random.default_rng(0)
    sys_prefix = rng.integers(0, JCFG.vocab_size, size=16).tolist()
    prompts = [sys_prefix + rng.integers(0, JCFG.vocab_size, size=8).tolist()
               for _ in range(4)]
    outs = {}
    for label, eng, gen, sp, stats_cls in (
            ("jax", jeng, j_generate, JSamplingParams, JEngineStats),
            ("torch", teng, generate, SamplingParams, EngineStats)):
        gen(eng, prompts, sp(max_tokens=4))        # warm: populates the tree
        eng.stats = stats_cls()
        outs[label] = [c.tokens for c in gen(eng, prompts, sp(max_tokens=4))]
    assert outs["torch"] == outs["jax"]
    assert _stats(teng) == _stats(jeng)
    assert teng.stats.prefix_hits > 0
    assert teng.stats.prefix_hit_rate == jeng.stats.prefix_hit_rate > 0.5
    assert teng.stats.prefill_launches == jeng.stats.prefill_launches
