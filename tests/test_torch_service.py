"""repro_torch's asyncio service against the JAX package's engine.

Each scenario of tests/test_service.py runs on the port's service over a
port engine on the CPU (the plain version of every kernel), with the
weights of one JAX engine (``from_jax_params``; the reduced fp32 config of
tests/test_chaos.py's ``ATTN``, built once per module): concurrent
streams give the JAX engine's ``generate`` tokens, and a drained service
restored on a fresh one continues to them.  The rest holds the service's
mechanics as the JAX tests do — disconnect, backpressure, deadline shed,
metrics, fair share, stop, rate limits, and the failure delivery of
tests/test_drain_restore.py (engine death, watchdog, a queued submit) —
and ``ServiceMetrics`` against the JAX copy on the same records.  Written
against plain asyncio (``asyncio.run`` inside sync tests).
"""

import asyncio
import dataclasses

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
from repro.serve.service import metrics as j_metrics
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)
from repro_torch.serve.resilience import FaultInjector
from repro_torch.serve.service import (AdmissionRejected, GenerateService,
                                       ServiceConfig, ServiceError,
                                       ServiceMetrics)
from repro_torch.serve.service import metrics as t_metrics

JCFG = JModelConfig(name="svc", family="dense", d_model=64, n_layers=2,
                    n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                    param_dtype=jnp.float32, compute_dtype=jnp.float32,
                    attn_block_kv=32)
S_MAX = 32
# the JAX engine's one bucket: it compiles two steps (decode, chunk 16)
JAX_EC = dict(s_max=S_MAX, block_pos_stride=4, buckets=(4,))


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _prompts(n, rng_seed=0, lo=2, hi=10):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, JCFG.vocab_size,
                         size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_pair(mesh16, plan16):
    """(the JAX engine, the port's weights from it)."""
    jeng = j_build_engine(JCFG, mesh16, plan16, seed=0,
                          engine_cfg=JEngineConfig(**JAX_EC))
    gp = jax.tree.map(np.asarray, gather_params(jeng.params, jeng.specs, 4, 4))
    return jeng, from_jax_params(gp, torch_config(JCFG), device="cpu")


@pytest.fixture
def engine(jax_pair):
    """``engine(**EngineConfig kw)``: a fresh port engine on the JAX
    engine's weights, on the CPU."""
    def make(**kw):
        kw.setdefault("buckets", (1, 2, 4))
        kw.setdefault("s_max", S_MAX)
        kw.setdefault("block_pos_stride", 4)
        return build_engine(torch_config(JCFG), params=jax_pair[1],
                            engine_cfg=EngineConfig(device="cpu", **kw))
    return make


def _drained(eng):
    return eng.pool.n_free == eng.pool.n_blocks


def test_concurrent_streams_match_jax_generate(jax_pair, engine):
    """tests/test_service.py:43: six concurrent clients through the
    service give the JAX engine's generate() tokens, token for token."""
    eng = engine(buckets=(4,))
    prompts = _prompts(6)

    async def main():
        async with GenerateService(eng, ServiceConfig(max_pending=8)) as svc:
            streams = [await svc.submit(p, max_tokens=5) for p in prompts]
            return await asyncio.gather(*[s.drain() for s in streams])

    results = asyncio.run(main())
    expect = j_generate(jax_pair[0], prompts, JSamplingParams(max_tokens=5))
    for (toks, comp), ref in zip(results, expect):
        assert toks == ref.tokens
        assert comp.finish_reason == "length"
        assert comp.queue_wait_s is not None and comp.queue_wait_s >= 0
        assert comp.ttft_s is not None and comp.ttft_s >= comp.queue_wait_s
    assert _drained(eng)


def test_client_disconnect_frees_resources_mid_stream(engine):
    eng = engine()
    p_short, p_long = _prompts(2, rng_seed=1)

    async def main():
        async with GenerateService(eng, ServiceConfig(max_pending=4)) as svc:
            doomed = await svc.submit(p_long, max_tokens=20)
            keeper = await svc.submit(p_short, max_tokens=6)
            got = [await doomed.__anext__(), await doomed.__anext__()]
            await doomed.aclose()
            toks, comp = await keeper.drain()
            return got, doomed, toks, comp

    got, doomed, toks, comp = asyncio.run(main())
    assert len(got) == 2
    assert doomed.request.finish_reason == "cancelled"
    assert comp.finish_reason == "length" and len(toks) == 6
    assert _drained(eng)


def test_backpressure_rejects_with_reason(engine):
    eng = engine()
    p = _prompts(1)[0]

    async def main():
        metrics = ServiceMetrics()
        async with GenerateService(eng, ServiceConfig(max_pending=1),
                                   metrics=metrics) as svc:
            first = await svc.submit(p, max_tokens=3)
            with pytest.raises(AdmissionRejected, match="max_pending=1"):
                await svc.submit(p, max_tokens=3)
            await first.drain()
            second = await svc.submit(p, max_tokens=3)
            _, comp = await second.drain()
        return metrics, comp

    metrics, comp = asyncio.run(main())
    assert comp.finish_reason == "length"
    snap = metrics.snapshot()
    assert snap["rejected"] == 1 and snap["submitted"] == 2

    async def bad():
        async with GenerateService(eng) as svc:
            with pytest.raises(ValueError, match="s_max"):
                await svc.submit(list(range(30)), max_tokens=8)
    asyncio.run(bad())


def test_deadline_policy_sheds_and_stream_reports_it(engine):
    eng = engine()
    p1, p2 = _prompts(2, rng_seed=2)

    async def main():
        svc = GenerateService(
            eng, ServiceConfig(admission="deadline", est_ttft_s=100.0))
        async with svc:
            doomed = await svc.submit(p1, max_tokens=4,
                                      ttft_deadline_s=0.001)
            fine = await svc.submit(p2, max_tokens=4)
            shed = await doomed.drain()
            ok = await fine.drain()
        return svc, shed, ok

    svc, (shed_toks, shed_comp), (ok_toks, ok_comp) = asyncio.run(main())
    assert shed_toks == [] and shed_comp.finish_reason == "shed"
    assert shed_comp.queue_wait_s is None
    assert ok_comp.finish_reason == "length" and len(ok_toks) == 4
    assert eng.scheduler.n_shed == 1
    snap = svc.metrics.snapshot()
    assert snap["shed"] == 1 and snap["completed"] == 1


def test_metrics_surface_records_latency_distributions(engine):
    eng = engine()
    prompts = _prompts(4, rng_seed=3)

    async def main():
        async with GenerateService(eng) as svc:
            streams = [await svc.submit(p, max_tokens=4) for p in prompts]
            await asyncio.gather(*[s.drain() for s in streams])
            return svc.metrics.snapshot(), list(svc.metrics.records)

    snap, records = asyncio.run(main())
    assert snap["submitted"] == snap["completed"] == 4
    assert snap["tokens"] == 16
    for key in ("ttft_s", "itl_s", "queue_wait_s"):
        st = snap[key]
        assert st["n"] > 0
        assert 0 <= st["p50"] <= st["p99"] <= st["max"]
    assert len(records) == 4
    for rm in records:
        assert rm.n_tokens == 4 and len(rm.itl_s) == 3
        assert rm.finish_reason == "length" and rm.tenant == "default"
    assert snap["prefill_s_per_token"] is not None


def test_fair_share_tenants_interleave_under_load(engine):
    eng = engine(buckets=(1,))
    pa = _prompts(3, rng_seed=4, lo=2, hi=4)
    pb = _prompts(1, rng_seed=5, lo=2, hi=4)[0]

    async def main():
        svc = GenerateService(eng, ServiceConfig(admission="fair_share"))
        async with svc:
            a_streams = [await svc.submit(p, max_tokens=3, tenant="a")
                         for p in pa]
            b_stream = await svc.submit(pb, max_tokens=3, tenant="b")
            return await asyncio.gather(
                *[s.drain() for s in (*a_streams, b_stream)])

    results = asyncio.run(main())
    *a_res, b_res = results
    assert all(c.finish_reason == "length" for _, c in results)
    assert b_res[1].queue_wait_s < max(c.queue_wait_s for _, c in a_res)


def test_service_stop_cancels_outstanding_streams(engine):
    eng = engine()
    p = _prompts(1, rng_seed=6)[0]

    async def main():
        svc = GenerateService(eng)
        await svc.start()
        stream = await svc.submit(p, max_tokens=20)
        await stream.__anext__()
        await svc.stop()
        return stream

    stream = asyncio.run(main())
    assert stream.request.finish_reason == "cancelled"
    assert _drained(eng)


def test_tenant_rate_limit_rejects_then_refills(engine):
    eng = engine()
    p = _prompts(1, rng_seed=9)[0]

    async def main():
        metrics = ServiceMetrics()
        cfg = ServiceConfig(max_pending=16,
                            tenant_rate_limits={"tiny": (2.0, 2.0)})
        async with GenerateService(eng, cfg, metrics=metrics) as svc:
            now = [1000.0]
            svc._now = lambda: now[0]
            s1 = await svc.submit(p, max_tokens=2, tenant="tiny")
            s2 = await svc.submit(p, max_tokens=2, tenant="tiny")
            with pytest.raises(AdmissionRejected) as ei:
                await svc.submit(p, max_tokens=2, tenant="tiny")
            assert ei.value.reason == "rate_limited"
            s3 = await svc.submit(p, max_tokens=2, tenant="big")
            now[0] += 0.5
            s4 = await svc.submit(p, max_tokens=2, tenant="tiny")
            for s in (s1, s2, s3, s4):
                await s.drain()
        return metrics

    snap = asyncio.run(main()).snapshot()
    assert (snap["rate_limited"], snap["rejected"], snap["submitted"]) == \
        (1, 1, 4)
    assert snap["tenants"]["tiny"] == \
        {"requests": 3, "tokens": 6, "rate_limited": 1}
    assert snap["tenants"]["big"] == \
        {"requests": 1, "tokens": 2, "rate_limited": 0}
    with pytest.raises(ValueError, match="rate"):
        ServiceConfig(tenant_rate_limits={"t": (0.0, 4.0)})
    with pytest.raises(ValueError, match="burst"):
        ServiceConfig(tenant_rate_limits={"t": (1.0, 0.5)})


def test_service_metrics_match_jax_copy():
    """The same records, rejections and engine-stat deltas folded into
    both packages' ServiceMetrics give the same snapshot."""
    snaps = []
    for mod in (t_metrics, j_metrics):
        m = mod.ServiceMetrics(window=4)
        for i in range(6):
            m.on_submitted()
            m.observe(mod.RequestMetrics(
                request_id=f"r{i}", tenant="ab"[i % 2], priority=0,
                finish_reason=("length", "stop", "shed", "error", "drained",
                               "cancelled")[i],
                n_tokens=i, ttft_s=None if i == 2 else 0.01 * (i + 1),
                queue_wait_s=None if i == 2 else 0.001 * i,
                itl_s=[0.002 * j for j in range(i)], n_prompt_tokens=3 + i))
        m.on_rejected()
        m.on_rate_limited("a")
        m.on_speculation(10, 7, 3)
        m.on_prefix(2, 8, 1, 20)
        m.on_checkpoint()
        m.on_restart(0.5)
        snaps.append(m.snapshot())
        assert [mod.percentile([5, 1, 3, 2], p) for p in (0, 50, 99)] == \
            [1, 2, 5]
    assert snaps[0] == snaps[1]
    assert snaps[0]["speculation"]["accept_rate"] == 0.7


# -- service-level drain / restore and failure delivery ------------------------

def test_service_drain_restore_roundtrip(jax_pair, engine, tmp_path):
    """tests/test_drain_restore.py:265: drain() ends every open stream as
    "drained"; restore() on a fresh service streams only the new tokens,
    and prefix + streamed equals the JAX engine's uninterrupted output."""
    path = str(tmp_path / "svc_drain.json")
    prompts = _prompts(4, rng_seed=2)
    expect = j_generate(jax_pair[0], prompts, JSamplingParams(max_tokens=8))
    eng = engine(buckets=(4,))

    async def phase1():
        svc = await GenerateService(eng, ServiceConfig(max_pending=8)).start()
        streams = [await svc.submit(p, max_tokens=8) for p in prompts]
        first = [await streams[0].__anext__() for _ in range(2)]
        assert await svc.drain(path) == 4
        with pytest.raises(RuntimeError):
            await svc.submit(prompts[0], max_tokens=2)
        streamed = {}
        for s in streams:
            streamed[s.request_id] = [t async for t in s]
            assert s.completion.finish_reason == "drained"
        streamed[streams[0].request_id][:0] = first
        assert svc.metrics.n_drained == 4
        return [s.request_id for s in streams], streamed

    order, streamed1 = asyncio.run(phase1())
    assert _drained(eng)
    eng2 = engine(buckets=(4,))

    async def phase2():
        async with GenerateService(eng2, ServiceConfig(max_pending=8)) as svc:
            streams = await svc.restore(path)
            assert len(streams) == 4
            pre = {s.request_id: len(s.request.output_tokens)
                   for s in streams}
            outs = {}
            for s in streams:
                new_toks = [t async for t in s]
                assert s.completion.tokens[pre[s.request_id]:] == new_toks
                outs[s.request_id] = s.completion.tokens
            return outs

    full = asyncio.run(phase2())
    for i, rid in enumerate(order):
        assert full[rid] == expect[i].tokens
        assert full[rid][:len(streamed1[rid])] == streamed1[rid]


def test_engine_death_wakes_streams_and_fails_submits(engine):
    eng = engine()
    prompts = _prompts(2)

    def dying_step():
        raise RuntimeError("boom: device fell over")

    async def main():
        svc = await GenerateService(eng, ServiceConfig(max_pending=4)).start()
        stream = await svc.submit(prompts[0], max_tokens=8)
        eng.step = dying_step
        svc._wake.set()
        with pytest.raises(RuntimeError, match="boom"):
            async for _ in stream:
                pass
        await asyncio.sleep(0.05)
        with pytest.raises(ServiceError):
            await svc.submit(prompts[1], max_tokens=2)
        with pytest.raises(RuntimeError, match="boom"):
            await svc.stop()

    asyncio.run(main())


def test_watchdog_declares_hung_step_dead(engine):
    eng = engine(fault_injector=FaultInjector(0, {"stall": 1.0},
                                              stall_s=0.8))

    async def main():
        svc = await GenerateService(
            eng, ServiceConfig(max_pending=4,
                               watchdog_timeout_s=0.15)).start()
        stream = await svc.submit(_prompts(1)[0], max_tokens=4)
        with pytest.raises(ServiceError, match="watchdog"):
            async for _ in stream:
                pass
        thread = svc._thread
        with pytest.raises(ServiceError, match="watchdog"):
            await svc.stop()
        return thread

    thread = asyncio.run(main())
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_queued_submit_is_woken_when_engine_dies(engine):
    eng = engine()

    def dying_submit(req):
        raise RuntimeError("boom at intake")

    async def main():
        svc = GenerateService(eng, ServiceConfig(max_pending=4))
        eng.submit_request = dying_submit
        await svc.start()
        stream = await svc.submit(_prompts(1)[0], max_tokens=2)
        with pytest.raises(RuntimeError, match="boom"):
            async for _ in stream:
                pass
        with pytest.raises(RuntimeError, match="boom"):
            await svc.stop()

    asyncio.run(main())


def test_launcher_serves_through_the_service_on_the_cpu():
    """``launch/serve.py --service`` (the JAX launcher's flags): Poisson
    clients through the service, the metrics snapshot printed; with
    neither --engine nor --service it decodes one fixed batch (the JAX
    launcher's default), and refuses whisper-base there, whose decoder
    needs an encoder pass."""
    import contextlib
    import io
    import json

    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2-0.5b", "--service", "--smoke",
                    "--device", "cpu", "--admission", "deadline",
                    "--ttft-slo", "30", "--rate", "50", "--requests", "3",
                    "--tokens", "4"])
    text = out.getvalue()
    assert "service (deadline admission, rate 50/s, cpu): 3 completed" \
        in text, text
    snap = json.loads(text[text.index("{"):])
    assert snap["submitted"] == 3 and snap["tokens"] == 12
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                    "--tokens", "2"])
    assert "decoded 2 tokens x batch 8 (gemv, s_max 64)" in out.getvalue()
    with pytest.raises(SystemExit, match="encoder pass"):
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--arch", "whisper-base", "--smoke", "--device",
                        "cpu"])
