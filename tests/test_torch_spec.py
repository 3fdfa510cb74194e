"""repro_torch's speculative decoding: its host pieces against the JAX
package's, and the engine against its own plain (non-speculative) run.

``_find_continuation``, ``accept_draft`` and ``SpeculationConfig`` are
copies, so they must give the JAX functions' results (and errors) on the
same seeded cases exactly.  The engine scenarios are the port versions of
tests/test_speculative.py's: greedy output equal to the plain engine's
token for token whatever the drafter, rollback then ``fork()``, a
self-drafting draft model accepted at rate 1.0, and the acceptance EMA's
fallback to plain decode.  Engines run on the CPU (the plain versions of
every kernel), fp32.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from repro.serve.spec import SpeculationConfig as JSpeculationConfig
from repro.serve.spec import accept_draft as j_accept_draft
from repro.serve.spec.drafter import \
    _find_continuation as j_find_continuation
from repro_torch.configs import get_config, reduced
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.spec import (DraftModelDrafter, Drafter,
                                    NgramDrafter, SpecDecoder,
                                    SpeculationConfig, accept_draft,
                                    softmax_rows)
from repro_torch.serve.spec.drafter import _find_continuation
from repro_torch.serve.state import layer_state_specs

F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32,
           attn_block_kv=32)
ATTN = ModelConfig(name="att", family="dense", d_model=64, n_layers=2,
                   n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128, **F32)
HYBRID = ModelConfig(
    name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
    ssm_headdim=16, ssm_state=16, ssm_groups=4,
    layer_pattern=(("attn", "mlp"), ("mamba", "mlp")), **F32)
S_MAX = 48


def _repetitive_prompts(rng, n, vocab):
    """Tiled short patterns: the regime prompt-lookup drafting targets."""
    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, size=int(rng.integers(2, 5))).tolist()
        out.append((pat * 6)[:12])
    return out


class _WrongDrafter:
    """Adversarial drafter: always proposes (last_token + 7) mod vocab
    repeated — near-certain rejections."""

    name = "wrong"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, request, k):
        t = request.seq_tokens[-1]
        return [(t + 7) % self.vocab] * max(1, k)

    def rollback(self, request):
        pass

    def release(self, request_id):
        pass


def _engine(cfg, speculation=None, params=None, **kw):
    ec = dict(s_max=S_MAX, buckets=(1, 2, 4), block_pos_stride=8,
              device="cpu", speculation=speculation)
    ec.update(kw)
    return build_engine(cfg, seed=0, params=params,
                        engine_cfg=EngineConfig(**ec))


# -- the copied host pieces against the JAX package --------------------------


def test_find_continuation_matches_jax():
    rng = np.random.default_rng(0)
    n_found = 0
    for _ in range(300):
        hist = rng.integers(0, 4, size=int(rng.integers(1, 24))).tolist()
        k = int(rng.integers(1, 6))
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        got = _find_continuation(hist, k, hi, lo)
        assert got == j_find_continuation(hist, k, hi, lo), (hist, k, lo, hi)
        n_found += bool(got)
    assert n_found > 100
    d = NgramDrafter(ngram_max=3, ngram_min=1)
    assert isinstance(d, Drafter)
    with pytest.raises(ValueError):
        NgramDrafter(ngram_max=2, ngram_min=3)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_accept_draft_matches_jax(temperature):
    """Random logit rows and drafts (half of them the rows' own argmaxes,
    so prefixes are accepted); at t = 0.8 both draw from one seeded
    Generator each, started alike."""
    rng = np.random.default_rng(1)
    ra = np.random.default_rng(2) if temperature else None
    rb = np.random.default_rng(2) if temperature else None
    seen = set()
    for _ in range(200):
        k = int(rng.integers(0, 5))
        rows = (rng.normal(size=(k + 1, 16)) * 2.0).astype(np.float32)
        draft = rng.integers(0, 16, size=k)
        if rng.random() < 0.5:
            draft = np.argmax(rows[:k], axis=1)
        draft = draft.tolist()
        got = accept_draft(rows, draft, temperature, ra)
        want = j_accept_draft(rows, draft, temperature, rb)
        assert got == want, (rows, draft)
        assert len(got[1]) == got[0] + 1
        seen.add(got[0] == k)
    assert seen == {True, False}
    with pytest.raises(ValueError):
        accept_draft(rows[:1], [1], 0.0, None)
    with pytest.raises(ValueError):
        accept_draft(rows[:1], [], 0.5, None)


def test_softmax_rows_is_the_engine_sampler():
    """``softmax_rows`` is bit-identical to the distribution
    ``ServingEngine._sample`` draws from: the same seeded draws give the
    same tokens."""
    eng = _engine(ATTN)
    req = eng.submit([1, 2, 3], SamplingParams(max_tokens=1,
                                               temperature=0.7, seed=5))
    row = np.random.default_rng(3).normal(size=128).astype(np.float32) * 3
    rng = np.random.default_rng(5)
    p = softmax_rows(row, 0.7)
    for _ in range(50):
        assert eng._sample(req, row) == int(rng.choice(len(row), p=p))


@pytest.mark.parametrize("kw", [
    dict(drafter="bogus"), dict(k=0), dict(ngram_min=3, ngram_max=2),
    dict(ema_alpha=0.0), dict(probe_every=0)])
def test_speculation_config_raises_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        JSpeculationConfig(**kw)
    with pytest.raises(ValueError) as got:
        SpeculationConfig(**kw)
    assert str(got.value) == str(want.value)


def test_spec_k_must_fit_s_max():
    with pytest.raises(ValueError, match="k"):
        _engine(ATTN, SpeculationConfig(k=16), s_max=16, buckets=(1,),
                block_pos_stride=4)


# -- the dense snapshot kept on the device --------------------------------


def test_snapshot_slots_hold_read_slot_values_and_restore():
    """``snapshot_slots`` gathers the same values ``read_slot`` copies to
    the host; ``restore_slot`` puts either back, counts a restore and
    leaves every other slot alone."""
    cfg = reduced(get_config("mamba2-780m"))
    store = StateStore(layer_state_specs(cfg, stride=8), n_blocks=4,
                       device=torch.device("cpu"), n_slots=4, stride=8)
    gen = torch.Generator().manual_seed(0)
    for entry in store.arena:
        for leaf in entry.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [{k: v.clone() for k, v in e.items()} for e in store.arena]
    snaps = store.snapshot_slots([2, 0])
    host0 = store.read_slot(0)
    for slot, snap in zip((2, 0), snaps):
        host = store.read_slot(slot)
        assert set(snap) == set(host)
        assert all(torch.equal(snap[key], host[key]) for key in host)
    for entry in store.arena:                  # the step overwrites both
        for leaf in entry.values():
            leaf[:, :3] += 1.0
    store.restore_slot(2, snaps[0])            # the device snapshot
    store.restore_slot(0, host0)               # a host one
    assert store.n_restores == 2
    for e, e0 in zip(store.arena, before):
        for name, leaf in e.items():
            assert torch.equal(leaf[:, 0], e0[name][:, 0])
            assert torch.equal(leaf[:, 2], e0[name][:, 2])
            assert torch.equal(leaf[:, 1], e0[name][:, 1] + 1.0)


# -- the engine against its own plain run -----------------------------------


def test_verify_step_and_ladder_chunk_of_one_length_are_two_steps():
    """At k = 15 a verify step feeds 16 positions, the length of the
    ladder's len16 chunk: the step cache keeps them apart (all rows against
    the last one), and a run that takes both gives the plain tokens."""
    eng = _engine(ATTN, SpeculationConfig("ngram", k=15), s_max=64,
                  prefill_chunks=(16,))
    chunk, verify = eng._kernel(2, 16), eng._kernel(2, 16, verify=True)
    assert chunk is not verify
    assert (chunk.name, verify.name) == ("prefill_bs2_len16",
                                         "verify_bs2_len16")
    assert tuple(chunk.rows.shape) == (2, 1, 128)
    assert tuple(verify.rows.shape) == (2, 16, 128)
    prompts = [[3, 9, 3, 9, 3, 9, 3, 9] * 3, [5, 6, 7] * 7]
    sampling = SamplingParams(max_tokens=20)
    spec = generate(eng, prompts, sampling)
    assert {"prefill_bs2_len16", "verify_bs2_len16"} <= set(
        eng.kernel_events())
    assert eng.stats.spec_launches > 0
    base = generate(_engine(ATTN, s_max=64, prefill_chunks=(16,),
                            params=eng.params), prompts, sampling)
    assert [c.tokens for c in spec] == [c.tokens for c in base]


def test_rollback_then_fork_shares_only_accepted_pages():
    """tests/test_speculative.py:259 — after a rejected-tail rewind
    released the speculative pages, a fork() adopts ONLY the accepted
    prefix and reproduces the parent's greedy tokens."""
    stride, plen, n_tok = 4, 9, 6
    eng = _engine(ATTN, SpeculationConfig(drafter="ngram", k=6),
                  buckets=(1, 2), block_pos_stride=stride,
                  prefill_chunks=())
    eng.spec.drafter = _WrongDrafter(ATTN.vocab_size)
    prompt = np.random.default_rng(8).integers(
        0, ATTN.vocab_size, size=plen).tolist()
    parent = eng.submit(prompt, SamplingParams(max_tokens=n_tok))
    for _ in range(plen):          # prefill: prompt pages publish
        eng.step()
    for _ in range(2):             # speculative decode rounds (rejections)
        eng.step()
    assert eng.stats.spec_rollbacks > 0
    child = eng.fork(parent)
    eng.drain()
    assert child.output_tokens == parent.output_tokens
    solo = eng.pool.blocks_for(plen + n_tok + 1)
    shared = (plen - 1) // stride
    assert eng.stats.peak_blocks_used <= 2 * solo - shared < 2 * solo
    assert eng.pool.n_free == eng.pool.n_blocks


def test_draft_model_self_draft_accepts_everything():
    """tests/test_speculative.py:289 — the draft-model drafter running the
    TARGET's own weights is a perfect oracle under greedy: every proposal
    is accepted, which pins the verify rows to the step-by-step path."""
    prompt = np.random.default_rng(5).integers(
        0, ATTN.vocab_size, size=6).tolist()
    sampling = SamplingParams(max_tokens=12)
    eng_off = _engine(ATTN, buckets=(1,))
    base = generate(eng_off, [prompt], sampling)
    eng_on = _engine(ATTN, SpeculationConfig(drafter="ngram", k=3),
                     buckets=(1,), params=eng_off.params)
    drafter = DraftModelDrafter(ATTN, s_max=S_MAX, stride=8,
                                params=eng_on.params, chunk=8, device="cpu")
    eng_on.spec = SpecDecoder(eng_on, SpeculationConfig("draft_model", k=3),
                              drafter=drafter)
    spec = generate(eng_on, [prompt], sampling)
    assert spec[0].tokens == base[0].tokens
    st = eng_on.stats
    assert st.spec_proposed_tokens > 0
    assert st.spec_accept_rate == 1.0
    assert drafter.n_launches > 0
    assert drafter.queue.n_executables == 1
    assert drafter.pool.n_free == drafter.pool.n_blocks   # all released


def test_draft_model_rejects_dense_configs():
    """tests/test_speculative.py:315."""
    with pytest.raises(NotImplementedError, match="attention-only"):
        DraftModelDrafter(HYBRID, s_max=S_MAX, stride=8, device="cpu")


def test_draft_model_takes_a_registry_name():
    """A name resolves through ``reduced(get_config(...))``; the engine's
    vocab check refuses a draft model whose vocab differs."""
    d = DraftModelDrafter("qwen3-0.6b", s_max=S_MAX, stride=8, device="cpu")
    assert d.cfg == reduced(get_config("qwen3-0.6b"))
    with pytest.raises(ValueError, match="vocab"):
        _engine(ATTN, SpeculationConfig("draft_model", k=2,
                                        draft_config="qwen3-0.6b"))


def test_ema_falls_back_to_plain_decode_then_probes():
    """tests/test_speculative.py:320 — drafts that never verify drive the
    acceptance EMA to zero: the slot decodes plainly, with a 1-token probe
    draft every ``probe_every`` rounds."""
    prompts = _repetitive_prompts(np.random.default_rng(3), 2,
                                  ATTN.vocab_size)
    sampling = SamplingParams(max_tokens=12)
    base = generate(_engine(ATTN), prompts, sampling)
    cfg = SpeculationConfig(drafter="ngram", k=4, ema_alpha=1.0,
                            probe_every=4)
    eng = _engine(ATTN, cfg)
    eng.spec = SpecDecoder(eng, cfg, drafter=_WrongDrafter(ATTN.vocab_size))
    spec = generate(eng, prompts, sampling)
    assert [c.tokens for c in spec] == [c.tokens for c in base]
    st = eng.stats
    assert st.decode_launches > 0
    assert st.spec_launches < st.decode_launches


def test_rollback_in_flight_restores_the_committed_position():
    """A verify round prepared and launched, then rolled back instead of
    committed (what a drain does mid-speculation): dense slots restored,
    draft pages freed, and driving on gives the uninterrupted run's tokens
    (ROADMAP §3's port version of the drain-mid-speculation scenario)."""
    prompts = _repetitive_prompts(np.random.default_rng(6), 3,
                                  HYBRID.vocab_size)
    sampling = SamplingParams(max_tokens=16)
    cfg = SpeculationConfig(drafter="ngram", k=3)
    ref = _engine(HYBRID, cfg)
    expect = generate(ref, prompts, sampling)

    eng = _engine(HYBRID, cfg, params=ref.params)
    eng.spec.drafter = _WrongDrafter(HYBRID.vocab_size)   # always drafts
    reqs = [eng.submit(p, sampling) for p in prompts]
    while not all(r.output_tokens for r in reqs):
        eng.step()
    sd = eng.scheduler.schedule()
    rnd = eng.spec.prepare(sd)
    assert rnd is not None and eng.spec._round is rnd
    eng.spec.launch(rnd)
    eng.queue.finish()
    committed = [list(r.output_tokens) for r in reqs]
    restores = eng.store.n_restores
    assert eng.spec.rollback_in_flight() == len(reqs)
    assert eng.spec._round is None
    assert eng.spec.rollback_in_flight() == 0              # idempotent
    assert eng.store.n_restores == restores + len(reqs)
    assert [list(r.output_tokens) for r in reqs] == committed
    for r in reqs:                                         # draft pages
        assert len(r.blocks.ids) == eng.pool.blocks_for(
            len(r.seq_tokens) + 1)
    eng.spec.drafter = ref.spec.drafter                    # back to ngram
    eng.drain()
    assert [r.output_tokens for r in reqs] == [c.tokens for c in expect]
    assert eng.pool.n_free == eng.pool.n_blocks


def test_launcher_serves_with_speculation_on_the_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2-0.5b", "--engine", "--smoke",
                    "--device", "cpu", "--speculation", "ngram",
                    "--spec-k", "3", "--requests", "3", "--tokens", "12"])
    text = out.getvalue()
    assert "speculation:" in text and "verify_bs" in text, text
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            serve.main(["--arch", "qwen2-0.5b", "--engine", "--device",
                        "cpu", "--speculation", "draft_model"])
