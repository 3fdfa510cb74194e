"""repro_torch's serving engine on SSM and hybrid configs against the JAX
engine on the same weights.

Each JAX engine runs on the 4x4 grid (``mesh16``/``plan16``, seed 0) and is
built once per module; the port's engine takes the same global weights
through ``from_jax_params`` and runs on the CPU with the plain version of
every kernel.  The host logic is a copy, so greedy tokens and every
``EngineStats`` counter — ``peak_dense_slots_used`` included — must be
identical.  The scenarios are those of tests/test_engine_state.py: the
reduced mamba2-780m and ``HYBRID`` served token-stepped and chunked,
identical prompts adopting the dense prefix snapshot, SSM preemption
restoring without replay, and a hybrid fork copying dense state while
sharing the prompt's pages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (DenseSlotPool, EngineConfig,
                                      PoolExhausted, SamplingParams,
                                      build_engine, generate)

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           attn_block_kv=32)
HYBRID = JModelConfig(
    name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
    ssm_headdim=16, ssm_state=16, ssm_groups=4,
    layer_pattern=(("attn", "mlp"), ("mamba", "mlp")), sub_quadratic=True,
    **F32)
CONFIGS = {"ssm": reduced(get_config("mamba2-780m")), "hybrid": HYBRID}
S_MAX = 32
STATS = ("steps", "prefill_launches", "prefill_chunk_launches",
         "decode_launches", "prompt_tokens_ingested", "tokens_generated",
         "migrations", "peak_blocks_used", "peak_dense_slots_used",
         "prefix_hits", "prefix_tokens_reused", "prefix_evictions")


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def engines(mesh16, plan16):
    """``engines(family, **engine_cfg)`` -> (JAX engine, port engine) on the
    same weights; each distinct JAX engine is built once per module, and
    its port twin is rebuilt fresh (the port's engines are cheap)."""
    built = {}

    def make(family, **kw):
        key = (family, tuple(sorted(kw.items())))
        if key not in built:
            jcfg = CONFIGS[family]
            jeng = j_build_engine(jcfg, mesh16, plan16, seed=0,
                                  engine_cfg=JEngineConfig(**kw))
            gp = jax.tree.map(np.asarray,
                              gather_params(jeng.params, jeng.specs, 4, 4))
            built[key] = (jeng, gp)
        jeng, gp = built[key]
        tcfg = torch_config(CONFIGS[family])
        teng = build_engine(tcfg, params=from_jax_params(gp, tcfg,
                                                         device="cpu"),
                            engine_cfg=EngineConfig(device="cpu", **kw))
        return jeng, teng
    return make


def _stats(eng):
    return {k: getattr(eng.stats, k) for k in STATS}


@pytest.mark.parametrize("chunks", [(), (4, 16)],
                         ids=["token-stepped", "chunked"])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_generate_matches_jax_engine(engines, family, chunks):
    """tests/test_engine_state.py:98 — four 9-token prompts, 5 greedy
    tokens, buckets (1, 2, 4), stride 4: mid-prompt snapshot boundaries,
    dense slot indirection, chunked multi-token state advance."""
    jeng, teng = engines(family, s_max=S_MAX, buckets=(1, 2, 4),
                         block_pos_stride=4, prefill_chunks=chunks)
    cfg = CONFIGS[family]
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(4, 9)).tolist()
    jo = j_generate(jeng, prompts, JSamplingParams(max_tokens=5))
    to = generate(teng, prompts, SamplingParams(max_tokens=5))
    assert [c.tokens for c in to] == [c.tokens for c in jo]
    assert all(c.finish_reason == "length" for c in to)
    assert _stats(teng) == _stats(jeng)
    assert teng.stats.peak_dense_slots_used > 0
    assert set(teng.kernel_events()) == set(jeng.kernel_events())
    # the same step operands: a table iff any layer pages KV, slots iff
    # any layer is dense
    assert (teng.store.needs_pages, teng.store.has_dense) == \
        (jeng.store.needs_pages, jeng.store.has_dense)
    # the JAX arena replicates dense rows over its 4 grid rows
    assert 4 * teng.store.dense_slot_bytes == jeng.store.dense_slot_bytes
    if family == "ssm":
        assert not teng.store.needs_pages
        assert teng.stats.peak_blocks_used == 0
    else:
        assert teng.pool.layout.bytes_per_block == \
            jeng.pool.layout.bytes_per_block


def test_ssm_identical_prompts_adopt_dense_prefix(engines):
    """tests/test_engine_state.py:251 — a second identical prompt resumes at
    the donor's published snapshot boundary, in both engines."""
    stride, plen = 4, 11
    prompt = np.random.default_rng(5).integers(
        0, CONFIGS["ssm"].vocab_size, size=plen).tolist()
    jeng, teng = engines("ssm", s_max=S_MAX, buckets=(1, 2),
                         block_pos_stride=stride, prefill_chunks=(16,))
    m0 = (plen - 1) // stride * stride
    outs = {}
    for label, eng, sp in (("jax", jeng, JSamplingParams),
                           ("torch", teng, SamplingParams)):
        restores = eng.store.n_restores
        a = eng.submit(prompt, sp(max_tokens=4))
        eng.step()
        assert a.num_cached == m0                      # boundary clamp
        eng.step()
        ingested = eng.stats.prompt_tokens_ingested
        b = eng.submit(prompt, sp(max_tokens=4))
        eng.drain()
        assert b.output_tokens == a.output_tokens
        assert eng.stats.prompt_tokens_ingested == ingested + (plen - m0)
        assert eng.store.n_restores == restores + 1
        outs[label] = a.output_tokens
    assert outs["torch"] == outs["jax"]


def test_ssm_preemption_restores_without_replay(engines):
    """tests/test_engine_state.py:218 — the preempted SSM request's dense
    leaves are snapshotted at eviction and restored at re-admission: zero
    replayed prompt tokens, and both engines' tokens unchanged."""
    rng = np.random.default_rng(3)
    vocab = CONFIGS["ssm"].vocab_size
    p1 = rng.integers(0, vocab, size=5).tolist()
    p2 = rng.integers(0, vocab, size=5).tolist()
    jeng, teng = engines("ssm", s_max=S_MAX, buckets=(1, 2),
                         block_pos_stride=4, prefill_chunks=(8,))
    base = j_generate(jeng, [p1, p2], JSamplingParams(max_tokens=8))
    r1 = teng.submit(p1, SamplingParams(max_tokens=8))
    r2 = teng.submit(p2, SamplingParams(max_tokens=8))
    for _ in range(4):
        teng.step()
    assert r2.output_tokens and not r2.is_finished
    assert teng.scheduler._preempt_one(keep=r1) is r2
    pos, leaves = r2.dense_snapshot
    assert pos == 7 and leaves
    assert all(t.device.type == "cpu" for t in leaves.values())
    ingested = teng.stats.prompt_tokens_ingested
    teng.drain()
    assert teng.store.n_restores == 1
    assert teng.stats.prompt_tokens_ingested == ingested
    assert r1.output_tokens == base[0].tokens
    assert r2.output_tokens == base[1].tokens


def test_hybrid_fork_copies_dense_state_and_shares_pages(engines):
    """tests/test_engine_state.py:180 — the fork's slot gets a physical copy
    of the parent's boundary snapshot while its table adopts the parent's
    prompt pages (refcount 2); both engines give the same tokens."""
    stride, plen, n_tok = 4, 9, 6
    prompt = np.random.default_rng(8).integers(
        0, HYBRID.vocab_size, size=plen).tolist()
    jeng, teng = engines("hybrid", s_max=S_MAX, buckets=(1, 2),
                         block_pos_stride=stride, prefill_chunks=(16,))
    m0 = (plen - 1) // stride * stride
    n_shared = m0 // stride
    outs = {}
    for label, eng, sp in (("jax", jeng, JSamplingParams),
                           ("torch", teng, SamplingParams)):
        restores = eng.store.n_restores
        parent = eng.submit(prompt, sp(max_tokens=n_tok))
        eng.step()
        assert parent.num_cached == m0
        assert eng.store.has_dense_prefix(tuple(prompt[:m0]))
        eng.step()
        child = eng.fork(parent)
        eng.step()
        assert child.dense_slot != parent.dense_slot
        assert eng.store.n_restores == restores + 1
        assert child.blocks.ids[:n_shared] == parent.blocks.ids[:n_shared]
        assert all(eng.pool.refcount(b) == 2
                   for b in child.blocks.ids[:n_shared])
        eng.drain()
        assert child.output_tokens == parent.output_tokens
        outs[label] = (parent.output_tokens, eng.stats.peak_blocks_used)
    assert outs["torch"] == outs["jax"]


def test_dense_slot_pool_alloc_release():
    pool = DenseSlotPool(2, slot_bytes=64)
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {0, 1} and pool.n_free == 0 and pool.n_used == 2
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.release(a)
    assert pool.n_free == 1
    with pytest.raises(ValueError):
        pool.release(a)                                  # double free
    assert pool.alloc() == a


def test_cancel_returns_dense_slots_to_pool():
    """tests/test_engine_state.py:329 — both abandonment paths (stream()
    closed mid-way, engine.cancel()) give the dense slot back."""
    cfg = torch_config(CONFIGS["ssm"])
    eng = build_engine(cfg, seed=0, engine_cfg=EngineConfig(
        s_max=S_MAX, buckets=(1, 2), block_pos_stride=4, device="cpu"))
    slots = eng.store.slot_pool
    prompt = list(range(1, 7))
    gen = eng.stream(prompt, SamplingParams(max_tokens=8))
    next(gen), next(gen)
    assert slots.n_used == 1
    gen.close()
    assert slots.n_used == 0
    r = eng.submit(prompt, SamplingParams(max_tokens=8))
    eng.step()
    assert slots.n_used == 1
    assert eng.cancel(r.request_id)
    assert r.finish_reason == "cancelled" and slots.n_used == 0
    assert not eng.scheduler.has_work
