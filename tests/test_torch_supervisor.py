"""repro_torch's replica supervisor against tests/test_supervisor.py.

Case for case the JAX package's supervisor matrix, over the port's engine
on the CPU (``device="cpu"``, the plain version of every kernel) in fp32,
on the same reduced ``ATTN`` and ``HYBRID`` configs: SIGKILLing the
replica worker mid-generation any number of times must be invisible to
every client (the streamed tokens equal the uninterrupted run token for
token, zero duplicated, zero dropped), the final restore leaks no pages or
dense slots, an injected kill with corrupted checkpoints falls back to
``.prev``, crash loops end in containment, and the watchdog declares a
wedged step dead.  The uninterrupted run is an in-process
``spec.build()`` engine.

One case holds the whole slice against the JAX package: a supervised port
run with two kills, on the JAX engine's weights (``EngineSpec.params_path``,
a ``torch.save`` file of ``from_jax_params``), gives the token lists of
the JAX ``generate()`` on the same weights and prompts.

These tests spawn real worker processes (multiprocessing spawn); each
spawn pays a child interpreter and a torch import (about 2 s on a CPU
host).
"""

import asyncio
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.runtime import RetryPolicy
from repro_torch.serve.engine import EngineConfig, SamplingParams, generate
from repro_torch.serve.resilience import FaultInjector
from repro_torch.serve.service import ServiceError
from repro_torch.serve.spec import SpeculationConfig
from repro_torch.serve.supervisor import (EngineSpec, ReplicaSupervisor,
                                          SupervisorConfig)

JF32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
            attn_block_kv=32)
J_ATTN = JModelConfig(name="att", family="dense", d_model=64, n_layers=2,
                      n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                      **JF32)
J_HYBRID = JModelConfig(
    name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
    ssm_headdim=16, ssm_state=16, ssm_groups=4,
    layer_pattern=(("attn", "mlp"), ("mamba", "mlp")), sub_quadratic=True,
    **JF32)


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


ATTN, HYBRID = torch_config(J_ATTN), torch_config(J_HYBRID)
S_MAX = 32


def _spec(cfg, **kw):
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("max_steps", 2000)
    params_path = kw.pop("params_path", None)
    ec = EngineConfig(s_max=S_MAX, block_pos_stride=4, device="cpu", **kw)
    return EngineSpec(model_cfg=cfg, engine_cfg=ec, seed=0,
                      params_path=params_path)


def _prompts(cfg, n, rng_seed=0, lo=2, hi=10):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _mixed_sampling(n, max_tokens):
    """Alternate greedy and temperature sampling so every soak covers
    both: temperature continuations lean on the checkpointed rng state."""
    return [SamplingParams(max_tokens=max_tokens)
            if i % 2 == 0 else
            SamplingParams(max_tokens=max_tokens, temperature=0.8,
                           seed=100 + i)
            for i in range(n)]


async def _run_with_kills(spec, prompts, sampling, sup_cfg, kill_at):
    """Drive one supervised run, hard-killing the worker each time the
    total delivered-token count crosses a ``kill_at`` threshold.  Returns
    (per-stream streamed tokens, completions, supervisor, replica stats).
    """
    async with ReplicaSupervisor(spec, sup_cfg) as sup:
        streams = [await sup.submit(p, max_tokens=sp.max_tokens,
                                    temperature=sp.temperature,
                                    seed=sp.seed)
                   for p, sp in zip(prompts, sampling)]
        streamed = {s.request_id: [] for s in streams}
        comps = {}

        async def consume(s):
            async for tok in s:
                streamed[s.request_id].append(tok)
            comps[s.request_id] = s.completion

        tasks = [asyncio.create_task(consume(s)) for s in streams]

        async def killer():
            for i, threshold in enumerate(kill_at):
                while sum(len(v) for v in streamed.values()) < threshold:
                    await asyncio.sleep(0.01)
                await sup.kill_replica()
                # wait for the failover before arming the next kill, so
                # each kill lands on a distinct incarnation
                while sup.n_spawns < i + 2:
                    await asyncio.sleep(0.05)

        await asyncio.gather(killer(), *tasks)
        stats = await sup.replica_stats()
        return ([streamed[s.request_id] for s in streams],
                [comps[s.request_id] for s in streams], sup, stats)


@pytest.mark.parametrize("cfg", [ATTN, HYBRID], ids=["attn", "hybrid"])
def test_failover_token_parity_zero_dup_zero_drop(cfg, tmp_path):
    """The acceptance soak: kill the worker mid-generation twice (greedy
    AND temperature requests in the same batch); every stream's tokens
    equal the uninterrupted reference exactly, the stream content equals
    the completion (no duplicate, no dropped token), and the final worker
    holds zero pages/slots after the restores."""
    spec = _spec(cfg)
    prompts = _prompts(cfg, 6, rng_seed=1)
    sampling = _mixed_sampling(6, max_tokens=8)
    expect = generate(spec.build(), prompts, sampling)

    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=2, fsync=False, max_respawns=5)
    streamed, comps, sup, stats = asyncio.run(_run_with_kills(
        spec, prompts, sampling, sup_cfg, kill_at=(6, 20)))

    assert sup.n_failovers == 2 and sup.n_spawns == 3
    for got, comp, e in zip(streamed, comps, expect):
        assert got == e.tokens                  # token-for-token parity
        assert comp.tokens == got               # zero dup / zero drop
        assert comp.finish_reason == e.finish_reason
    # zero leaked pages/slots after the final restore
    assert stats["pool_free"] == stats["pool_blocks"]
    assert stats["dense_slots_used"] == 0
    assert stats["live_requests"] == 0
    snap = sup.metrics.snapshot()
    assert snap["failover"]["restarts"] == 2
    assert snap["failover"]["checkpoints"] >= 1
    assert snap["failover"]["recovery_s"]["max"] > 0
    # each failover is on the record, with the next incarnation ready
    assert len(sup.failovers) == 2 and len(sup.incarnations) == 3
    for rec in sup.failovers:
        inc = rec["incarnation"]
        assert rec["t_detect"] <= rec["t_exit"] <= inc["t_spawn"] \
            <= inc["t_enter"] <= inc["t_ready"]


def test_injected_kill_and_checkpoint_corruption_roundtrip(tmp_path):
    """The chaos path end to end: the worker's own injector hard-kills the
    process mid-soak and corrupts checkpoints as they land (truncation),
    so failover exercises the previous-good fallback; completions still
    reach full greedy parity with the fault-free reference."""
    clean = _spec(ATTN)
    prompts = _prompts(ATTN, 4, rng_seed=3)
    sampling = [SamplingParams(max_tokens=8)] * 4
    expect = generate(clean.build(), prompts, sampling)

    # seed 1's replayed schedule (every incarnation pickles the same
    # injector snapshot), the JAX test's: corrupt checkpoints, hard-kill
    inj = FaultInjector(1, {"process_kill": 0.06, "checkpoint_corrupt": 0.5},
                        max_faults=6)
    spec = _spec(ATTN, fault_injector=inj)
    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=2, fsync=False, max_respawns=10)
    streamed, comps, sup, stats = asyncio.run(_run_with_kills(
        spec, prompts, sampling, sup_cfg, kill_at=()))

    assert sup.n_failovers >= 1                  # the injector actually killed
    assert sup.n_ckpt_corruptions >= 1           # ... and actually corrupted
    for got, comp, e in zip(streamed, comps, expect):
        assert got == e.tokens
        assert comp.tokens == got
    assert stats["pool_free"] == stats["pool_blocks"]
    assert stats["live_requests"] == 0


def test_crash_loop_containment_budget(tmp_path):
    """Kills faster than the checkpoint cadence exhaust ``max_respawns``:
    surviving streams end ``finish_reason == "error"`` with their
    delivered tokens retained, the supervisor reports unhealthy, and new
    submits fail fast: no infinite respawn loop."""
    spec = _spec(ATTN)
    [prompt] = _prompts(ATTN, 1, rng_seed=2, lo=3, hi=6)
    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=10**6,       # no checkpoint ever lands
        fsync=False, max_respawns=1,
        respawn_backoff=RetryPolicy(max_retries=0, backoff_s=0.01,
                                    growth=2.0, max_backoff_s=0.1))

    async def main():
        async with ReplicaSupervisor(spec, sup_cfg) as sup:
            stream = await sup.submit(prompt, max_tokens=16)
            got = []

            async def consume():
                async for tok in stream:
                    got.append(tok)

            task = asyncio.create_task(consume())
            while not got:                       # first token flowed
                await asyncio.sleep(0.01)
            await sup.kill_replica()             # respawn 1: within budget
            while sup.n_spawns < 2:
                await asyncio.sleep(0.05)
            while len(got) < 2:                  # recomputation caught up
                await asyncio.sleep(0.01)
            await sup.kill_replica()             # respawn 2: budget blown
            await task
            assert stream.completion is not None
            assert stream.completion.finish_reason == "error"
            assert stream.completion.tokens == got   # delivered retained
            assert not sup.healthy
            with pytest.raises(ServiceError, match="unhealthy"):
                await sup.submit(prompt, max_tokens=4)
            assert sup.metrics.snapshot()["error"] == 1
        # containment is a reported state: stop() does not raise

    asyncio.run(main())


def test_watchdog_kills_wedged_step_then_contains(tmp_path):
    """A step that overstays ``watchdog_timeout_s`` (injected stall) after
    the incarnation's first step (its amnesty) is declared dead: the
    supervisor SIGKILLs the worker and fails over; with ``max_respawns=0``
    the very first watchdog failover exhausts the budget and the stream
    ends ``"error"``: replica death via the watchdog, not process exit."""
    inj = FaultInjector(0, {"stall": 1.0}, stall_s=2.0)
    spec = _spec(ATTN, fault_injector=inj)
    [prompt] = _prompts(ATTN, 1, rng_seed=5, lo=3, hi=6)
    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=10**6, fsync=False,
        watchdog_timeout_s=0.5, heartbeat_s=0.02, max_respawns=0)

    async def main():
        async with ReplicaSupervisor(spec, sup_cfg) as sup:
            stream = await sup.submit(prompt, max_tokens=16)
            toks, comp = await stream.drain()
            assert comp.finish_reason == "error"
            assert not sup.healthy
            assert "watchdog" in sup._unhealthy_reason
            assert sup.n_failovers == 1

    asyncio.run(main())


def test_supervisor_clean_run_and_stop(tmp_path):
    """No kills: the supervised replica is just a slower GenerateService:
    full parity, periodic checkpoints land, stats round-trips, and stop()
    shuts the worker down cleanly (no failover recorded)."""
    spec = _spec(ATTN)
    prompts = _prompts(ATTN, 3, rng_seed=4)
    sampling = _mixed_sampling(3, max_tokens=6)
    expect = generate(spec.build(), prompts, sampling)

    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=2, fsync=True)
    streamed, comps, sup, stats = asyncio.run(_run_with_kills(
        spec, prompts, sampling, sup_cfg, kill_at=()))

    assert sup.n_failovers == 0 and sup.n_spawns == 1
    for got, comp, e in zip(streamed, comps, expect):
        assert got == e.tokens and comp.tokens == got
    assert sup.metrics.snapshot()["failover"]["checkpoints"] >= 1
    # the fsynced checkpoint file survives on disk with its .prev rotation
    assert os.path.exists(sup_cfg.checkpoint_path) \
        or os.path.exists(sup_cfg.checkpoint_path + ".prev")
    assert stats["pool_free"] == stats["pool_blocks"]
    # the worker's own counts: the plain attention on every layer of
    # every launch (the CPU), nothing built
    launches = sum(stats["step_launches"].values())
    assert stats["kernel_launches"]["paged_attention_ref"] \
        == ATTN.n_layers * launches
    assert stats["kernel_launches"]["paged_attention_cuda"] == 0
    assert not any(stats["kernel_builds"].values())


def test_supervisor_config_validation():
    with pytest.raises(ValueError, match="max_pending"):
        SupervisorConfig(checkpoint_path="x", max_pending=0)
    with pytest.raises(ValueError, match="max_respawns"):
        SupervisorConfig(checkpoint_path="x", max_respawns=-1)
    with pytest.raises(ValueError, match="watchdog"):
        SupervisorConfig(checkpoint_path="x", watchdog_timeout_s=0.0)


def test_engine_spec_refuses_live_objects():
    """A spec must cross into a spawned worker: an engine config holding a
    tensor or a drafter object is refused when the spec is made; a
    drafter named by kind is taken."""
    _spec(ATTN, speculation=SpeculationConfig("draft_model", k=2))
    sc = SpeculationConfig("ngram")
    object.__setattr__(sc, "drafter", torch.zeros(1))
    with pytest.raises(TypeError, match="speculation.drafter"):
        _spec(ATTN, speculation=sc)


# ---------------------------------------------------------------------------
# The slice against the JAX package.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine(mesh16, plan16):
    """The JAX engine on ``J_ATTN``, built once for the module; one batch
    bucket, so it compiles two steps (decode, chunk 16)."""
    return j_build_engine(J_ATTN, mesh16, plan16, seed=0,
                          engine_cfg=JEngineConfig(
                              s_max=S_MAX, block_pos_stride=4,
                              buckets=(4,), max_steps=2000))


def test_supervised_port_gives_jax_tokens_on_jax_weights(jax_engine,
                                                         tmp_path):
    """A supervised port run with two kills, on the JAX engine's weights
    (params_path), streams the JAX ``generate()`` tokens exactly."""
    gp = jax.tree.map(np.asarray, gather_params(
        jax_engine.params, jax_engine.specs, 4, 4))
    path = str(tmp_path / "params.pt")
    torch.save(from_jax_params(gp, ATTN, device="cpu"), path)
    prompts = _prompts(ATTN, 6, rng_seed=7)
    want = [c.tokens for c in j_generate(
        jax_engine, prompts, JSamplingParams(max_tokens=8))]
    spec = _spec(ATTN, params_path=path, buckets=(4,))
    sup_cfg = SupervisorConfig(
        checkpoint_path=str(tmp_path / "replica.ckpt"),
        checkpoint_every_steps=2, fsync=False, max_respawns=5)
    streamed, comps, sup, stats = asyncio.run(_run_with_kills(
        spec, prompts, [SamplingParams(max_tokens=8)] * len(prompts),
        sup_cfg, kill_at=(6, 20)))
    assert sup.n_failovers == 2
    assert streamed == want
    assert [c.tokens for c in comps] == want
    assert stats["pool_free"] == stats["pool_blocks"]


def test_launcher_serves_supervised_on_the_cpu():
    """``launch/serve.py --supervised --smoke --device cpu``: the worker
    is killed once mid-generation, every request completes, and the
    supervised metrics snapshot is printed; without ``--device cpu`` and
    with no card it raises."""
    import contextlib
    import io
    import json

    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2-0.5b", "--supervised", "--smoke",
                    "--device", "cpu", "--kills", "1", "--requests", "3",
                    "--tokens", "6"])
    text = out.getvalue()
    assert "supervised replica: 3 completed / 18 tokens across 1 " \
        "failovers" in text, text
    assert "failover #1" in text
    snap = json.loads(text[text.index("{"):])
    assert snap["completed"] == 3 and snap["failover"]["restarts"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "qwen2-0.5b", "--supervised", "--smoke"])
