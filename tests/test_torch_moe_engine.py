"""repro_torch's serving engine on the MoE configs against the JAX engine on
the same weights.

The configs: the reduced qwen3-moe-235b-a22b, kimi-k2-1t-a32b and
jamba-1.5-large-398b (attention, mamba and MoE layers in one pattern), and
the ``HYBRID`` config of tests/test_decode.py:21 (a mamba + MoE layer).
Each JAX engine runs on the 4x4 grid (``mesh16``/``plan16``, seed 0) and
is built once per module; the port's engine takes the same global weights
through ``from_jax_params`` and runs on the CPU with the plain version of
every kernel.

``capacity_factor`` is pinned to 16, as tests/test_decode.py:24 and
``repro.models.ref`` pin it: capacity is ``ceil(T*k / n_pes * cf)``, so at
the reduced 2.0 the 16-PE grid (cap ``ceil(T/4)``) drops pairs that one
card keeps; at 16 neither drops any.

* the engines: greedy tokens and every ``EngineStats`` counter identical,
  and the step bodies' logits of every live lane of every launch (chunked
  prefill, token-stepped prefill, decode) rel < 1e-4 (max abs difference
  over max abs value), as tests/test_torch_decode.py holds them;
* reduced qwen3-moe with n-gram speculation (k = 4): tokens and the
  ``spec_*`` counters identical to the JAX speculative engine's.
"""

import dataclasses

import numpy as np
import pytest

import jax

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.models.ref import gather_params
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import EngineStats as JEngineStats
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro.serve.spec import SpeculationConfig as JSpeculationConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                      SamplingParams, build_engine, generate)
from repro_torch.serve.spec import SpeculationConfig
from test_decode import HYBRID
from test_torch_ssm import torch_config

CF = 16.0
CONFIGS = {
    "qwen3-moe": dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b")), capacity_factor=CF),
    "kimi-k2": dataclasses.replace(
        reduced(get_config("kimi-k2-1t-a32b")), capacity_factor=CF),
    "jamba": dataclasses.replace(
        reduced(get_config("jamba-1.5-large-398b")), capacity_factor=CF),
    "hybrid": HYBRID,
}
EC = dict(s_max=32, buckets=(1, 2, 4), block_pos_stride=4,
          prefill_chunks=(8,))
LOGIT_TOL = 1e-4
STATS = [f.name for f in dataclasses.fields(EngineStats)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


@pytest.fixture(scope="module")
def jax_engines(mesh16, plan16):
    """``jax_engines(name, speculation)`` -> (JAX engine, its global weights
    as numpy); each is built once per module."""
    built = {}

    def get(name, speculation=False):
        key = (name, speculation)
        if key not in built:
            spec = JSpeculationConfig("ngram", k=4) if speculation else None
            jeng = j_build_engine(CONFIGS[name], mesh16, plan16, seed=0,
                                  engine_cfg=JEngineConfig(
                                      **EC, speculation=spec))
            gp = jax.tree.map(np.asarray,
                              gather_params(jeng.params, jeng.specs, 4, 4))
            built[key] = (jeng, gp)
        return built[key]
    return get


def _record_rows(eng, vocab):
    """Keep each launch's logits rows of the lanes that hold a request."""
    rows_seen = []
    commit = eng._commit

    def record(sd, rows, fed, *rest):
        rows_seen.append(np.stack([rows[s, :vocab] for s, r in
                                   enumerate(sd.slots) if r is not None]))
        return commit(sd, rows, fed, *rest)
    eng._commit = record
    return rows_seen


def _port_engine(name, gp, **kw):
    tcfg = torch_config(CONFIGS[name])
    assert tcfg.capacity_factor == CF and tcfg.n_experts == \
        CONFIGS[name].n_experts
    return build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                        engine_cfg=EngineConfig(device="cpu", **EC, **kw))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_matches_jax_engine(jax_engines, name):
    """Four prompts of mixed lengths (chunked, token-stepped tails, decode
    riders), five greedy tokens each."""
    jeng, gp = jax_engines(name)
    teng = _port_engine(name, gp)
    rng = np.random.default_rng(11)
    vocab = CONFIGS[name].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (9, 3, 14, 6)]
    jeng.stats = JEngineStats()
    jrows, trows = _record_rows(jeng, vocab), _record_rows(teng, vocab)
    try:
        want = j_generate(jeng, prompts, JSamplingParams(max_tokens=5))
    finally:
        del jeng._commit
    got = generate(teng, prompts, SamplingParams(max_tokens=5))
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert len(trows) == len(jrows) == teng.stats.launches
    for j, (a, b) in enumerate(zip(jrows, trows)):
        assert a.shape == b.shape and _rel(a, b) < LOGIT_TOL, j
    assert all(c.finish_reason == "length" for c in got)
    assert {k: getattr(teng.stats, k) for k in STATS} == \
        {k: getattr(jeng.stats, k) for k in STATS}
    assert teng.stats.prefill_chunk_launches > 0
    assert set(teng.kernel_events()) == set(jeng.kernel_events())


def test_ngram_speculation_matches_jax_engine(jax_engines):
    """Repetitive prompts (tests/test_speculative.py:49), n-gram drafts of
    up to k = 4 tokens verified in one launch a round."""
    jeng, gp = jax_engines("qwen3-moe", speculation=True)
    teng = _port_engine("qwen3-moe", gp,
                        speculation=SpeculationConfig("ngram", k=4))
    rng = np.random.default_rng(0)
    vocab = CONFIGS["qwen3-moe"].vocab_size
    prompts = []
    for _ in range(3):
        pat = rng.integers(0, vocab, size=int(rng.integers(2, 5))).tolist()
        prompts.append((pat * 6)[:12])
    jeng.stats = JEngineStats()
    want = j_generate(jeng, prompts, JSamplingParams(max_tokens=12))
    got = generate(teng, prompts, SamplingParams(max_tokens=12))
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert {k: getattr(teng.stats, k) for k in STATS} == \
        {k: getattr(jeng.stats, k) for k in STATS}
    st = teng.stats
    assert st.spec_launches > 0 and st.spec_proposed_tokens > 0
    assert st.spec_proposed_tokens == \
        st.spec_accepted_tokens + st.spec_rejected_tokens
