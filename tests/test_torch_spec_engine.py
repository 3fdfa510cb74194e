"""repro_torch's speculative engine against the JAX speculative engine on
the same weights.

For each of ``ATTN``, ``HYBRID`` (tests/test_speculative.py:38-45) and the
reduced mamba2-780m, in fp32, one JAX engine with speculation (k = 4) runs
on the 4x4 grid (``mesh16``/``plan16``, seed 0), built once per module;
the port's engine takes the same global weights through
``from_jax_params`` and runs on the CPU with the plain version of every
kernel.  Each drafter case swaps a fresh ``SpecDecoder`` into both:

* ``ngram`` — prompt lookup, greedy;
* ``wrong`` — an adversarial drafter: every draft is rejected, so every
  verify round rolls back (dense configs restore their snapshots);
* ``eos`` — an oracle drafter proposing the plain run's own tokens, with
  an EOS that the plain run emits in the middle of an accepted draft;
* ``t0.8`` — the oracle drafter at temperature 0.8, from seeded
  generators: drafts accepted or resampled at random.

The host logic is a copy, so the tokens, the ``spec_*`` counters,
``decode_launches``, ``prefill_launches`` and the dense restores must be
identical to the JAX engine's — not close.  Greedy tokens must also equal
the port's own non-speculative engine's.
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
from repro.serve.engine import EngineStats as JEngineStats
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro.serve.spec import SpecDecoder as JSpecDecoder
from repro.serve.spec import SpeculationConfig as JSpeculationConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)
from repro_torch.serve.spec import SpecDecoder, SpeculationConfig

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           attn_block_kv=32)
ATTN = JModelConfig(name="att", family="dense", d_model=64, n_layers=2,
                    n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128, **F32)
HYBRID = JModelConfig(
    name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
    ssm_headdim=16, ssm_state=16, ssm_groups=4,
    layer_pattern=(("attn", "mlp"), ("mamba", "mlp")), sub_quadratic=True,
    **F32)
CONFIGS = {"attn": ATTN, "hybrid": HYBRID,
           "ssm": reduced(get_config("mamba2-780m"))}
EC = dict(s_max=48, buckets=(1, 2, 4), block_pos_stride=8)
K = 4
MAX_TOKENS = 16
COUNTERS = ("spec_launches", "spec_proposed_tokens", "spec_accepted_tokens",
            "spec_rejected_tokens", "spec_rollbacks", "decode_launches",
            "prefill_launches", "tokens_generated")


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


class _WrongDrafter:
    """Proposes (last token + 7) mod vocab, k times: rejected."""

    name = "wrong"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, request, k):
        return [(request.seq_tokens[-1] + 7) % self.vocab] * max(1, k)

    def rollback(self, request):
        pass

    def release(self, request_id):
        pass


class _OracleDrafter:
    """Proposes the plain run's continuation of each prompt: every draft
    is accepted, up to where the sampled sequence leaves the plain one."""

    name = "oracle"

    def __init__(self, plain):
        self.plain = plain          # prompt tuple -> plain greedy tokens

    def propose(self, request, k):
        i = len(request.output_tokens)
        return self.plain[tuple(request.prompt)][i:i + k]

    def rollback(self, request):
        pass

    def release(self, request_id):
        pass


def _repetitive_prompts(rng, n, vocab):
    """tests/test_speculative.py:49: tiled short patterns."""
    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, size=int(rng.integers(2, 5))).tolist()
        out.append((pat * 6)[:12])
    return out


@pytest.fixture(scope="module")
def jax_engines(mesh16, plan16):
    """``jax_engines(family)`` -> (JAX speculative engine, its global
    weights as numpy); each is built once per module."""
    built = {}

    def get(family):
        if family not in built:
            jeng = j_build_engine(
                CONFIGS[family], mesh16, plan16, seed=0,
                engine_cfg=JEngineConfig(
                    **EC, speculation=JSpeculationConfig("ngram", k=K)))
            gp = jax.tree.map(np.asarray,
                              gather_params(jeng.params, jeng.specs, 4, 4))
            built[family] = (jeng, gp)
        return built[family]
    return get


@pytest.mark.parametrize("case", ["ngram", "wrong", "eos", "t0.8"])
@pytest.mark.parametrize("family", ["attn", "hybrid", "ssm"])
def test_speculative_engine_matches_jax_engine(jax_engines, family, case):
    jeng, gp = jax_engines(family)
    jcfg = CONFIGS[family]
    tcfg = torch_config(jcfg)
    params = from_jax_params(gp, tcfg, device="cpu")
    vocab = jcfg.vocab_size
    seed = {"ngram": 0, "wrong": 1, "eos": 2, "t0.8": 3}[case]
    prompts = _repetitive_prompts(np.random.default_rng(seed), 3, vocab)

    plain = build_engine(tcfg, params=params,
                         engine_cfg=EngineConfig(device="cpu", **EC))
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    base = generate(plain, prompts, sampling)
    scfg = SpeculationConfig("ngram", k=K)
    jscfg = JSpeculationConfig("ngram", k=K)
    make_drafter = lambda: None                          # noqa: E731
    jsampling = JSamplingParams(max_tokens=MAX_TOKENS)
    table = {tuple(p): c.tokens for p, c in zip(prompts, base)}
    if case == "wrong":
        make_drafter = lambda: _WrongDrafter(vocab)      # noqa: E731
    elif case in ("eos", "t0.8"):
        make_drafter = lambda: _OracleDrafter(table)     # noqa: E731
    if case == "eos":
        eos = base[0].tokens[2]      # inside the first verify's draft
        sampling = SamplingParams(max_tokens=MAX_TOKENS, eos_token_id=eos)
        jsampling = JSamplingParams(max_tokens=MAX_TOKENS, eos_token_id=eos)
        base = generate(plain, prompts, sampling)
    elif case == "t0.8":
        sampling = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.8,
                                  seed=11)
        jsampling = JSamplingParams(max_tokens=MAX_TOKENS, temperature=0.8,
                                    seed=11)

    teng = build_engine(tcfg, params=params, engine_cfg=EngineConfig(
        device="cpu", speculation=scfg, **EC))
    teng.spec = SpecDecoder(teng, scfg, drafter=make_drafter())
    got = generate(teng, prompts, sampling)

    jeng.spec = JSpecDecoder(jeng, jscfg, drafter=make_drafter())
    jeng.stats = JEngineStats()
    restores0 = jeng.store.n_restores
    want = j_generate(jeng, prompts, jsampling)

    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert {k: getattr(teng.stats, k) for k in COUNTERS} == \
        {k: getattr(jeng.stats, k) for k in COUNTERS}
    assert teng.store.n_restores == jeng.store.n_restores - restores0
    st = teng.stats
    assert st.spec_launches > 0
    assert st.spec_proposed_tokens == \
        st.spec_accepted_tokens + st.spec_rejected_tokens
    assert st.launches == \
        st.decode_launches + st.prefill_launches + st.spec_launches
    assert teng.pool.n_free == teng.pool.n_blocks
    if teng.store.has_dense:
        assert teng.store.slot_pool.n_used == 0
    if case != "t0.8":              # greedy: the plain engine's tokens
        assert [c.tokens for c in got] == [c.tokens for c in base]
        assert [c.finish_reason for c in got] == \
            [c.finish_reason for c in base]
    if case == "wrong":
        assert st.spec_rejected_tokens > 0
        if teng.store.has_dense:
            assert st.spec_rollbacks > 0
            assert teng.store.n_restores >= st.spec_rollbacks
    if case == "eos":
        eos = sampling.eos_token_id
        assert st.spec_accept_rate == 1.0
        assert got[0].finish_reason == "stop" and got[0].tokens[-1] == eos
