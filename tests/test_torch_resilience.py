"""repro_torch's resilience layer against the JAX package's.

The injector, the retry policy and the checkpoint format are copies, so
the same seed must draw the same fault schedule and a checkpoint written
by either package must restore in the other.  The guarded engine is held
against the guarded JAX engine on the same weights, the reduced fp32
``ATTN`` / ``HYBRID`` configs of tests/test_chaos.py: one JAX engine (and
its port twin, on the CPU with the plain version of every kernel) is
built per config per module and re-armed for each scenario of
tests/test_chaos.py, so both sides share one history.  Tokens, finish
reasons, every ``EngineStats`` counter (``fault_*`` included) and the
fired-fault events must be identical — not close — and every request that
survives must keep the unguarded greedy tokens.  Drain/restore follows
tests/test_drain_restore.py (attn and ssm round trips, the sampling rng,
file handling) and crosses the packages in both directions; the drain
mid-speculation scenario of tests/test_speculative.py:340 is held against
the uninterrupted run's tokens.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.runtime import retry as jretry
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import EngineStats as JEngineStats
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro.serve.resilience import FaultInjected as JFaultInjected
from repro.serve.resilience import FaultInjector as JFaultInjector
from repro.serve.resilience import ResilienceConfig as JResilienceConfig
from repro.serve.resilience import StepGuard as JStepGuard
from repro.serve.resilience import checkpoint as jckpt
from repro.serve.spec import SpecDecoder as JSpecDecoder
from repro.serve.spec import SpeculationConfig as JSpeculationConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.runtime import RetryPolicy, retry_with_backoff
from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                      SamplingParams, build_engine, generate)
from repro_torch.serve.resilience import (SITES, FaultInjected,
                                          FaultInjector, ResilienceConfig,
                                          StepGuard)
from repro_torch.serve.resilience import checkpoint as tckpt
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
CONFIGS = {"attn": ATTN, "hybrid": HYBRID}
S_MAX = 32
# one batch bucket: each JAX engine compiles two steps (decode, chunk 16)
EC = dict(s_max=S_MAX, block_pos_stride=4, buckets=(4,), max_steps=2000)
SOAK = {"launch": 0.10, "device": 0.08, "nan_logits": 0.04, "pool": 0.08,
        "stall": 0.03}


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _prompts(vocab, n, rng_seed=0, lo=2, hi=12):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _repetitive(vocab, n, seed):
    """tests/test_speculative.py:49: tiled short patterns."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, size=int(rng.integers(2, 5))).tolist()
        out.append((pat * 6)[:12])
    return out


def _drained(eng):
    return eng.pool.n_free == eng.pool.n_blocks and (
        eng.store.slot_pool is None or eng.store.slot_pool.n_used == 0)


@dataclasses.dataclass
class Pair:
    """A JAX engine and its port twin on the same weights."""
    jeng: object
    teng: object
    tcfg: ModelConfig

    def fresh_port(self, **kw):
        """Another port engine on the same weights (a restore target)."""
        ec = dict(EC, device="cpu", **kw)
        return build_engine(self.tcfg, params=self.teng.params,
                            engine_cfg=EngineConfig(**ec))


@pytest.fixture(scope="module")
def pairs(mesh16, plan16):
    """``pairs(family)`` -> :class:`Pair`, built once per module."""
    built = {}

    def get(family):
        if family not in built:
            jcfg = CONFIGS[family]
            jeng = j_build_engine(jcfg, mesh16, plan16, seed=0,
                                  engine_cfg=JEngineConfig(**EC))
            gp = jax.tree.map(np.asarray,
                              gather_params(jeng.params, jeng.specs, 4, 4))
            tcfg = torch_config(jcfg)
            teng = build_engine(tcfg, params=from_jax_params(
                gp, tcfg, device="cpu"), engine_cfg=EngineConfig(
                    **EC, device="cpu"))
            built[family] = Pair(jeng, teng, tcfg)
        return built[family]
    return get


def _arm(eng, guard_cls, res_cls, inj, res):
    """(Re-)arm ``eng``'s guard (None, None: disarm it)."""
    eng.engine_cfg = dataclasses.replace(eng.engine_cfg, fault_injector=inj,
                                         resilience=res)
    eng.guard = None if inj is None and res is None \
        else guard_cls(eng, res or res_cls())


def _run_both(pair, prompts, max_tokens, inj_args=None, res_kw=None):
    """Serve ``prompts`` on both engines, armed with injectors built from
    ``inj_args`` (positional, keyword) and a ResilienceConfig from
    ``res_kw`` (None: no config); returns (port completions, JAX
    completions, port injector, JAX injector)."""
    out = []
    for eng, inj_cls, guard_cls, res_cls, gen, sp in (
            (pair.teng, FaultInjector, StepGuard, ResilienceConfig,
             generate, SamplingParams),
            (pair.jeng, JFaultInjector, JStepGuard, JResilienceConfig,
             j_generate, JSamplingParams)):
        inj = None if inj_args is None else inj_cls(*inj_args[0],
                                                    **inj_args[1])
        res = None if res_kw is None else res_cls(**res_kw)
        _arm(eng, guard_cls, res_cls, inj, res)
        eng.stats = (JEngineStats if guard_cls is JStepGuard
                     else EngineStats)()
        out.append((gen(eng, prompts, sp(max_tokens=max_tokens)), inj))
        assert _drained(eng)
        _arm(eng, guard_cls, res_cls, None, None)
    (tout, tinj), (jout, jinj) = out
    return tout, jout, tinj, jinj


def _events(inj, completions):
    """The injector's fired events, each request id in a detail replaced by
    its request's position (each package numbers requests itself)."""
    pos = {c.request_id: i for i, c in enumerate(completions)}
    return [(e.index, e.site, pos.get(e.detail, e.detail))
            for e in inj.events]


# -- the injector and the retry policy ----------------------------------------

def _schedule(inj_cls, exc_cls, seed):
    """Query every site of a fresh injector in a fixed order; returns the
    hits, the event list and the counts."""
    inj = inj_cls(seed, {"launch": 0.3, "device": 0.2, "nan_logits": 0.2,
                         "pool": 0.3, "stall": 0.1, "process_kill": 0.05,
                         "checkpoint_corrupt": 0.05},
                  pool_steal_frac=0.4, pool_hold_steps=3, max_faults=40)
    hits = []
    for i in range(60):
        for site in ("launch", "device"):
            try:
                inj.fire(site)
            except exc_cls as e:
                hits.append((site, i, e.site, e.enqueued))
        hits.append(("nan", inj.corrupt_row(f"r{i}")))
        hits.append(("stall", inj.stall()))
        hits.append(("pool", inj.pool_steal(i % 7)))
        hits.append(("kill", inj.kill_process()))
        hits.append(("ckpt", inj.corrupt_checkpoint()))
    events = [(e.index, e.site, e.detail) for e in inj.events]
    return hits, events, inj.counts()


@pytest.mark.parametrize("seed", [0, 11, 1234])
def test_injector_schedules_equal_jax(seed):
    """Same seed, same queries -> the same hits, events and counts as the
    JAX injector (tests/test_chaos.py:60), until ``max_faults`` stops it."""
    got = _schedule(FaultInjector, FaultInjected, seed)
    want = _schedule(JFaultInjector, JFaultInjected, seed)
    assert got == want
    assert len(got[1]) == 40 and set(SITES) == set(got[2])


def test_injector_and_retry_validation_match_jax():
    for kw in ({"rates": {"gpu_on_fire": 1.0}}, {"rates": {"launch": 1.5}},
               {"pool_steal_frac": 0.0}, {"pool_hold_steps": 0}):
        for cls in (FaultInjector, JFaultInjector):
            with pytest.raises(ValueError):
                cls(0, **kw)
    for kw in ({"max_retries": -1}, {"backoff_s": -1.0}, {"growth": 0.5},
               {"max_backoff_s": -1.0}):
        for cls in (RetryPolicy, jretry.RetryPolicy):
            with pytest.raises(ValueError):
                cls(**kw)
    with pytest.raises(ValueError, match="max_request_failures"):
        ResilienceConfig(max_request_failures=-1)
    for kw in ({}, {"backoff_s": 0.5}, {"backoff_s": 0.1, "growth": 2.0,
                                        "max_backoff_s": 0.3}):
        p, q = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
        assert [p.delay_s(n) for n in range(6)] == \
            [q.delay_s(n) for n in range(6)]
    # three transient failures: two retries, then the third re-raises
    calls, slept = [], []

    def flaky():
        calls.append(1)
        raise FaultInjected("launch")
    with pytest.raises(FaultInjected):
        retry_with_backoff(flaky, policy=RetryPolicy(max_retries=2),
                           transient=(FaultInjected,), sleep=slept.append)
    assert len(calls) == 3 and slept == [0.01, 0.02]


# -- the guarded engine against the guarded JAX engine -------------------------

# (config, prompts (n, seed), max_tokens, injector (seed, rates, kw),
#  ResilienceConfig kw or None): the scenarios of tests/test_chaos.py, plus
# an armed guard with no injector
SCENARIOS = {
    "transient": ("attn", (4, 0), 6, (5, {"launch": 0.25, "device": 0.15},
                                      {"max_faults": 30}), {}),
    "device": ("attn", (3, 6), 5, (0, {"device": 1.0}, {"max_faults": 3}),
               {}),
    "exhaust": ("attn", (3, 0), 4, (0, {"launch": 1.0}, {}),
                {"max_request_failures": 1}),
    "nan_quarantine": ("attn", (3, 0), 6,
                       (0, {"nan_logits": 1.0}, {"max_faults": 1}),
                       {"max_request_failures": 0}),
    "nan_refeed": ("hybrid", (2, 3), 5,
                   (0, {"nan_logits": 1.0}, {"max_faults": 2}),
                   {"max_request_failures": 3}),
    "pool": ("attn", (6, 2), 6, (9, {"pool": 0.6}, {
        "pool_steal_frac": 0.9, "pool_hold_steps": 3, "max_faults": 50}),
        None),
    "soak_attn": ("attn", (8, 7), 6, (1234, SOAK, {
        "stall_s": 0.001, "max_faults": 60}), {"max_request_failures": 2}),
    "soak_hybrid": ("hybrid", (8, 7), 6, (1234, SOAK, {
        "stall_s": 0.001, "max_faults": 60}), {"max_request_failures": 2}),
    "quiet_attn": ("attn", (6, 5), 6, None, {}),
    "quiet_hybrid": ("hybrid", (6, 5), 6, None, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guarded_engine_matches_guarded_jax_engine(pairs, name):
    family, (n, seed), mt, inj, res = SCENARIOS[name]
    pair = pairs(family)
    prompts = _prompts(CONFIGS[family].vocab_size, n, rng_seed=seed)
    inj_args = None if inj is None else ((inj[0], inj[1]), inj[2])
    # the unguarded run first: the survivors' reference, and the plain
    # engine's stats, which a quiet guard must leave unchanged
    plain, jplain, _, _ = _run_both(pair, prompts, mt)
    assert pair.teng.guard is None and pair.jeng.guard is None
    assert [c.tokens for c in plain] == [c.tokens for c in jplain]
    assert not any(v for k, v in dataclasses.asdict(pair.teng.stats).items()
                   if k.startswith("fault_"))

    got, want, tinj, jinj = _run_both(pair, prompts, mt, inj_args, res)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert dataclasses.asdict(pair.teng.stats) == \
        dataclasses.asdict(pair.jeng.stats)
    if inj is not None:
        assert _events(tinj, got) == _events(jinj, want)
        assert tinj.n_fired > 0
    for g, p in zip(got, plain):
        assert g.finish_reason is not None
        if g.finish_reason != "error":
            assert g.tokens == p.tokens
            assert g.finish_reason == p.finish_reason
    st = pair.teng.stats
    if name == "transient":
        assert st.fault_retries > 0
        assert all(g.finish_reason != "error" for g in got)
    elif name == "device":
        assert (tinj.n_fired, st.fault_launch_failures,
                st.fault_retries) == (3, 3, 2)
    elif name == "exhaust":
        assert [g.finish_reason for g in got] == ["error"] * 3
        assert st.fault_quarantined == 3 and st.tokens_generated == 0
    elif name == "nan_quarantine":
        assert [g.finish_reason for g in got].count("error") == 1
    elif name == "nan_refeed":
        assert (st.fault_nonfinite, st.fault_quarantined) == (2, 0)
        assert pair.teng.store.n_restores > 0
    elif name == "pool":
        assert st.fault_pool_steals > 0
    elif name.startswith("quiet"):
        # an armed guard that never fires: the plain engine's tokens and
        # stats on two fresh engines
        quiet = pair.fresh_port(resilience=ResilienceConfig())
        bare = pair.fresh_port()
        outs = [generate(e, prompts, SamplingParams(max_tokens=mt))
                for e in (quiet, bare)]
        assert [c.tokens for c in outs[0]] == [c.tokens for c in outs[1]]
        assert dataclasses.asdict(quiet.stats) == \
            dataclasses.asdict(bare.stats)
        assert quiet.guard is not None and bare.guard is None


def test_speculative_chaos_matches_jax_engine(pairs):
    """tests/test_chaos.py:281 on the port: launch/device/nan faults on
    verify rounds, the guard's phased ``spec_step`` and commit's
    ``skip``; identical to the JAX engine, survivors keep the plain
    greedy tokens."""
    pair = pairs("attn")
    prompts = _repetitive(ATTN.vocab_size, 6, 11)
    plain = generate(pair.fresh_port(), prompts, SamplingParams(max_tokens=8))
    inj = ((77, {"launch": 0.12, "device": 0.08, "nan_logits": 0.05}),
           {"max_faults": 40})
    # speculation (n-gram, k = 3) on both engines for this run
    for eng, dec, scfg in ((pair.teng, SpecDecoder, SpeculationConfig),
                           (pair.jeng, JSpecDecoder, JSpeculationConfig)):
        eng.engine_cfg = dataclasses.replace(
            eng.engine_cfg, speculation=scfg(drafter="ngram", k=3))
        eng.spec = dec(eng, eng.engine_cfg.speculation)
    try:
        got, want, tinj, jinj = _run_both(pair, prompts, 8, inj,
                                          {"max_request_failures": 2})
    finally:
        for eng in (pair.teng, pair.jeng):
            eng.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                                 speculation=None)
            eng.spec = None
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert dataclasses.asdict(pair.teng.stats) == \
        dataclasses.asdict(pair.jeng.stats)
    assert _events(tinj, got) == _events(jinj, want)
    st = pair.teng.stats
    assert tinj.n_fired > 0 and st.spec_launches > 0
    for g, p in zip(got, plain):
        if g.finish_reason != "error":
            assert g.tokens == p.tokens


def test_speculative_chaos_on_dense_state_keeps_plain_tokens():
    """The hybrid half of tests/test_chaos.py:281, held against the port's
    own fault-free non-speculative engine: verify rounds that fault roll
    their dense snapshots back before the retry."""
    cfg = torch_config(HYBRID)
    ec = dict(EC, device="cpu")
    plain_eng = build_engine(cfg, seed=0, engine_cfg=EngineConfig(**ec))
    prompts = _repetitive(cfg.vocab_size, 6, 11)
    plain = generate(plain_eng, prompts, SamplingParams(max_tokens=8))
    inj = FaultInjector(77, {"launch": 0.12, "device": 0.08,
                             "nan_logits": 0.05}, max_faults=40)
    eng = build_engine(cfg, params=plain_eng.params, engine_cfg=EngineConfig(
        **ec, fault_injector=inj,
        resilience=ResilienceConfig(max_request_failures=2),
        speculation=SpeculationConfig(drafter="ngram", k=3)))
    got = generate(eng, prompts, SamplingParams(max_tokens=8))
    assert inj.n_fired > 0 and eng.stats.spec_launches > 0
    assert eng.stats.fault_retries > 0
    for g, p in zip(got, plain):
        assert g.finish_reason is not None
        if g.finish_reason != "error":
            assert g.tokens == p.tokens
            assert g.finish_reason == p.finish_reason
    assert _drained(eng)


# -- drain / restore ------------------------------------------------------------

@pytest.mark.parametrize("family", ["attn", "ssm"])
def test_drain_restore_roundtrip_token_parity(family, tmp_path):
    """tests/test_drain_restore.py:60: cut mid-flight, drain, restore into
    a FRESH engine; the restored outputs equal the uninterrupted run's."""
    cfg = torch_config(ATTN) if family == "attn" \
        else reduced(get_config("mamba2-780m"))
    ec = EngineConfig(**EC, device="cpu")
    path = str(tmp_path / "drain.json")
    prompts = _prompts(cfg.vocab_size, 5, rng_seed=1, hi=10)
    ref = build_engine(cfg, seed=0, engine_cfg=ec)
    expect = generate(ref, prompts, SamplingParams(max_tokens=6))

    eng = build_engine(cfg, params=ref.params, engine_cfg=ec)
    reqs = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    for _ in range(4):
        eng.step()
    mid = [list(r.output_tokens) for r in reqs]
    n = eng.drain_to(path)
    assert n == sum(r.finish_reason == "drained" for r in reqs) > 0
    assert all(r.is_finished for r in reqs) and _drained(eng)

    eng2 = build_engine(cfg, params=ref.params, engine_cfg=ec)
    restored = eng2.restore_from(path)
    drained = [(r, t) for r, t in zip(reqs, mid)
               if r.finish_reason == "drained"]
    assert [r.request_id for r in restored] == \
        [r.request_id for r, _ in drained]
    assert [r.output_tokens for r in restored] == [t for _, t in drained]
    eng2.drain()
    pos = {r.request_id: i for i, r in enumerate(reqs)}
    for r in restored:
        e = expect[pos[r.request_id]]
        assert r.output_tokens == e.tokens
        assert r.finish_reason == e.finish_reason


def test_drain_preserves_sampling_rng_state(tmp_path):
    """tests/test_drain_restore.py:114: temperature sampling continues
    with the exact tokens the uninterrupted engine draws."""
    cfg = torch_config(ATTN)
    ec = EngineConfig(**EC, device="cpu")
    path = str(tmp_path / "drain.json")
    prompts = _prompts(cfg.vocab_size, 3, rng_seed=4, hi=10)
    sp = SamplingParams(max_tokens=8, temperature=0.8, seed=123)
    ref = build_engine(cfg, seed=0, engine_cfg=ec)
    expect = generate(ref, prompts, sp)
    eng = build_engine(cfg, params=ref.params, engine_cfg=ec)
    reqs = [eng.submit(p, sp) for p in prompts]
    for _ in range(6):
        eng.step()
    assert any(r.output_tokens for r in reqs)
    eng.drain_to(path)
    eng2 = build_engine(cfg, params=ref.params, engine_cfg=ec)
    restored = eng2.restore_from(path)
    eng2.drain()
    pos = {r.request_id: i for i, r in enumerate(reqs)}
    for r in restored:
        assert r.output_tokens == expect[pos[r.request_id]].tokens


def _normalized(payload):
    """A checkpoint payload with each request id replaced by its position
    (each package numbers its requests with its own counter)."""
    out = json.loads(json.dumps(payload))
    for i, rec in enumerate(out["requests"]):
        rec["request_id"] = i
    return out


@pytest.mark.parametrize("case", ["attn", "attn_t0.8", "hybrid"])
def test_checkpoints_cross_packages(pairs, case, tmp_path):
    """Both engines drained at the same step write equal payloads; the
    JAX file restores into a fresh port engine and the port file into the
    JAX engine, and each continues to the JAX engine's uninterrupted
    tokens."""
    family = case.split("_")[0]
    pair = pairs(family)
    t = 0.8 if case.endswith("t0.8") else 0.0
    prompts = _prompts(CONFIGS[family].vocab_size, 5, rng_seed=21, hi=10)
    want = j_generate(pair.jeng, prompts, JSamplingParams(
        max_tokens=8, temperature=t, seed=5))
    # the same history on both engines: the uninterrupted run leaves the
    # same prefix pages and dense snapshots cached in each
    assert [c.tokens for c in generate(pair.teng, prompts, SamplingParams(
        max_tokens=8, temperature=t, seed=5))] == [c.tokens for c in want]
    paths = {}
    for label, eng, sp in (
            ("jax", pair.jeng, JSamplingParams),
            ("torch", pair.teng, SamplingParams)):
        reqs = [eng.submit(p, sp(max_tokens=8, temperature=t, seed=5))
                for p in prompts]
        for _ in range(5):
            eng.step()
        assert any(r.output_tokens for r in reqs)
        paths[label] = str(tmp_path / f"{label}.ckpt")
        assert eng.drain_to(paths[label]) == len(prompts)
        assert _drained(eng)
    jp = jckpt.load_checkpoint(paths["jax"])
    tp = tckpt.load_checkpoint(paths["torch"])
    assert _normalized(tp) == _normalized(jp)
    assert any(rec["output_tokens"] for rec in tp["requests"])
    if t:
        assert all(rec["rng_state"] for rec in tp["requests"]
                   if rec["output_tokens"])

    teng = pair.fresh_port()
    trest = teng.restore_from(paths["jax"])
    teng.drain()
    jrest = pair.jeng.restore_from(paths["torch"])
    pair.jeng.drain()
    assert [r.output_tokens for r in trest] == [c.tokens for c in want]
    assert [r.output_tokens for r in jrest] == [c.tokens for c in want]
    assert [r.finish_reason for r in trest] == \
        [c.finish_reason for c in want]


def _two_checkpoints(mod, tmp_path):
    path = str(tmp_path / "ckpt.json")
    old = {"version": 2, "requests": [{"request_id": "req-old"}]}
    new = {"version": 2, "requests": [{"request_id": "req-new"}]}
    mod.write_checkpoint(old, path)
    mod.write_checkpoint(new, path)
    return path, old, new


@pytest.mark.parametrize("corrupt", [None, "truncate", "bitflip",
                                     "future_version", "both"])
def test_checkpoint_file_handling_matches_jax(tmp_path, corrupt):
    """tests/test_drain_restore.py:178-262 on the port's functions: the
    ``.prev`` rotation, the fallback from a truncated, bit-flipped or
    future-version file, failing closed when no good file is left; and
    the port's files are byte for byte the JAX package's."""
    path, old, new = _two_checkpoints(tckpt, tmp_path / "t")
    jpath, _, _ = _two_checkpoints(jckpt, tmp_path / "j")
    for p in (path, path + tckpt.PREV_SUFFIX):
        assert open(p, "rb").read() == open(
            p.replace(str(tmp_path / "t"), str(tmp_path / "j")), "rb").read()
    assert tckpt._parse_checkpoint(path + tckpt.PREV_SUFFIX) == old
    assert jckpt.load_checkpoint(path) == new
    raw = open(path, "rb").read()
    if corrupt is None:
        assert tckpt.load_checkpoint(path) == new
        return
    if corrupt == "truncate":
        bad = raw[: len(raw) - 7]
    elif corrupt == "bitflip":
        bad = raw[:-4] + bytes([raw[-4] ^ 0x10]) + raw[-3:]
    elif corrupt == "future_version":
        nl = raw.find(b"\n")
        hdr = json.loads(raw[:nl])
        hdr["version"] = 99
        bad = json.dumps(hdr).encode() + raw[nl:]
    else:
        bad = raw[: len(raw) // 2]
        prev = open(path + tckpt.PREV_SUFFIX, "rb").read()
        with open(path + tckpt.PREV_SUFFIX, "wb") as f:
            f.write(prev[: len(prev) // 2])
    with open(path, "wb") as f:
        f.write(bad)
    if corrupt == "both":
        with pytest.raises(ValueError, match="no good drain checkpoint"):
            tckpt.load_checkpoint(path)
        os.unlink(path + tckpt.PREV_SUFFIX)
        with pytest.raises(ValueError):
            tckpt.load_checkpoint(path)
        return
    assert tckpt.load_checkpoint(path) == old == jckpt.load_checkpoint(path)


def test_legacy_v1_checkpoint_loads_and_unknown_version_fails(tmp_path):
    path = tmp_path / "v1.json"
    payload = {"version": 1, "requests": [{"request_id": "r0"}]}
    path.write_text(json.dumps(payload))
    assert tckpt.load_checkpoint(str(path)) == payload
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 99, "requests": []}')
    eng = build_engine(torch_config(ATTN), seed=0,
                       engine_cfg=EngineConfig(**EC, device="cpu"))
    with pytest.raises(ValueError, match="version"):
        eng.restore_from(str(bad))


def test_drain_mid_speculation_rolls_back_uncommitted_tail(tmp_path):
    """tests/test_speculative.py:340 on the port, held against the tokens
    of the uninterrupted run (as that test asserts at :394): ``drain_to``
    while a verify round is in flight restores the dense slots, frees the
    draft pages and truncates the drafter first, so the checkpoint holds
    committed tokens only and the restored run continues token for
    token."""
    cfg = torch_config(HYBRID)
    path = str(tmp_path / "drain.json")
    prompts = _repetitive(cfg.vocab_size, 3, 6)
    sampling = SamplingParams(max_tokens=16)
    kw = dict(s_max=S_MAX, buckets=(1, 2, 4), block_pos_stride=8,
              device="cpu")
    ref = build_engine(cfg, seed=0, engine_cfg=EngineConfig(**kw))
    expect = generate(ref, prompts, sampling)

    ec_on = EngineConfig(**kw, speculation=SpeculationConfig(
        drafter="ngram", k=3))
    eng = build_engine(cfg, params=ref.params, engine_cfg=ec_on)
    reqs = [eng.submit(p, sampling) for p in prompts]
    for _ in range(4):
        eng.step()
    assert any(r.output_tokens for r in reqs)
    assert not all(r.is_finished for r in reqs)
    sd = eng.scheduler.schedule()
    rnd = eng.spec.prepare(sd)
    assert rnd is not None
    eng.spec.launch(rnd)
    eng.queue.finish()
    assert eng.spec._round is rnd
    committed = {r.request_id: list(r.output_tokens) for r in reqs}
    restores_before = eng.store.n_restores

    assert eng.drain_to(path) > 0
    assert eng.spec._round is None
    assert eng.store.n_restores > restores_before
    assert _drained(eng)
    payload = tckpt.load_checkpoint(path)
    assert {rec["request_id"]: rec["output_tokens"]
            for rec in payload["requests"]} == \
        {r.request_id: committed[r.request_id] for r in reqs
         if r.finish_reason == "drained"}

    eng2 = build_engine(cfg, params=ref.params, engine_cfg=ec_on)
    restored = eng2.restore_from(path)
    eng2.drain()
    pos = {r.request_id: i for i, r in enumerate(reqs)}
    for r in restored:
        e = expect[pos[r.request_id]]
        assert r.output_tokens == e.tokens
        assert r.finish_reason == e.finish_reason
