"""The port's serving engine on a 2x2 grid of PE processes against the JAX
engine on a 2x2 grid.

The JAX engine (the tests/test_torch_engine.py config with QKV bias, fp32)
runs on a 2x2 mesh of 4 host devices, its weights drawn with numpy from
seed 0 by the JAX initializer's rules.  Its global weights
(``gather_params`` at 2x2) go to four CPU PE processes, each of which cuts
its blocks (``shard_params``) and builds the port's engine on them
(``serve_on_grid``): PE 0 schedules, every PE runs each step body, and the
collectives put through the shared-memory heaps.  On a mixed workload the
greedy tokens and every EngineStats counter must be identical to JAX's,
the first decode step's logits within rel 1e-5 (fp32 sums in another
order), and equal token for token to the port's one-device engine on the
same weights.  Each step's heap traffic must be the count reckoned from
the shapes (``grid_messages``), and every PE must have run the paged
attention (on its own grid row) and the heap's put and reduction.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax.sharding import NamedSharding

from repro.models import params as pm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.models.transformer import param_specs
from repro.partition import DATA, MODEL
from repro.partition import MeshPlan as JMeshPlan
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params, shard_params
from repro_torch.partition import grid_plan
from repro_torch.serve.decode import grid_messages
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      ServingEngine, build_engine, generate)
from repro_torch.serve.engine.grid import (GridJob, heap_bytes_by_step,
                                           reckoned_heap_bytes,
                                           serve_on_grid, step_shape)

from test_torch_decode_fixed import init_numpy, torch_config

JCFG = JModelConfig(name="eng", family="dense", d_model=64, n_layers=2,
                    n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                    qkv_bias=True, param_dtype=jnp.float32,
                    compute_dtype=jnp.float32, attn_block_kv=32)
EC = dict(s_max=32, buckets=(4,), block_pos_stride=4)
STATS = ("steps", "prefill_launches", "prefill_chunk_launches",
         "decode_launches", "prompt_tokens_ingested", "tokens_generated",
         "migrations", "peak_blocks_used", "prefix_hits",
         "prefix_tokens_reused", "prefix_evictions")
PLAN = grid_plan(2, 2)
# the grid forms of layer_norm, the gelu MLP and its biases (port only)
LN_CFG = ModelConfig(name="eng-ln", family="dense", d_model=64, n_layers=2,
                     n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                     norm="layernorm", act="gelu", mlp_bias=True,
                     param_dtype=torch.float32, compute_dtype=torch.float32,
                     attn_block_kv=32)


def _workload():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, JCFG.vocab_size,
                            size=int(rng.integers(2, 20))).tolist()
               for _ in range(6)]
    return prompts, [int(rng.integers(3, 8)) for _ in range(6)]


def _record(eng, prompts):
    """Logits rows of every request's first two sampled tokens (the second
    comes from the first decode step)."""
    rows, sample = {}, eng._sample

    def sampled(req, row):
        k = (prompts.index(list(req.prompt)), len(req.output_tokens))
        if k[1] < 2:
            rows[k] = np.array(row)
        return sample(req, row)
    eng._sample = sampled
    return rows


@pytest.fixture(scope="module")
def runs():
    mesh = jax.make_mesh((1, 4), (DATA, MODEL), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jplan = JMeshPlan((DATA, MODEL), (1, 4), 2, 2)
    # natural blocks on the 2x2 grid drawn with numpy (no per-leaf jit)
    specs = param_specs(JCFG, 2, 2, preskew=False)
    host = init_numpy(specs, seed=0)
    jeng = j_build_engine(JCFG, mesh, jplan, engine_cfg=JEngineConfig(**EC),
                          params=jax.tree.map(
                              lambda a, s: jax.device_put(
                                  a, NamedSharding(mesh, s)),
                              host, pm.param_pspecs(specs)))
    gp = jax.tree.map(np.asarray, gather_params(host, specs, 2, 2))
    prompts, mt = _workload()
    tcfg = torch_config(JCFG)
    ec = EngineConfig(device="cpu", **EC)
    sampling = [SamplingParams(max_tokens=m) for m in mt]
    # the PE processes serve while JAX compiles and serves here; their
    # second job is the layernorm / gelu / MLP-bias variant, drawn from a
    # seed on every PE
    with ThreadPoolExecutor(1) as ex:
        grid = ex.submit(serve_on_grid, [
            GridJob(tcfg, ec, prompts, sampling, weights=gp, record=2),
            GridJob(LN_CFG, ec, prompts, sampling, seed=0, record=2)],
            PLAN, device="cpu", timeout=60)
        jrows = _record(jeng, prompts)
        jout = j_generate(jeng, prompts, [JSamplingParams(max_tokens=m)
                                          for m in mt])
        grid, ln_grid = grid.result()
    one = build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                       engine_cfg=ec)
    ones = generate(one, prompts, sampling)
    ln_one = build_engine(LN_CFG, seed=0, engine_cfg=ec)
    ln_rows = _record(ln_one, prompts)
    ln_ones = generate(ln_one, prompts, sampling)
    return dict(jeng=jeng, jout=jout, jrows=jrows, grid=grid, one=ones,
                tcfg=tcfg, gp=gp, ln_grid=ln_grid, ln_one=ln_ones,
                ln_rows=ln_rows)


def test_tokens_and_stats_match_jax_engine(runs):
    pe0 = runs["grid"][0]
    assert pe0["tokens"] == [c.tokens for c in runs["jout"]]
    assert pe0["finish"] == [c.finish_reason for c in runs["jout"]]
    jst = runs["jeng"].stats
    assert {k: pe0["stats"][k] for k in STATS} == \
        {k: getattr(jst, k) for k in STATS}
    assert pe0["peak_kv_bytes"] == runs["jeng"].peak_kv_bytes()


def test_first_decode_logits_match_jax(runs):
    rows, jrows = runs["grid"][0]["rows"], runs["jrows"]
    assert set(rows) == set(jrows) and any(k[1] == 1 for k in rows)
    for k, want in jrows.items():
        np.testing.assert_allclose(rows[k], want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_grid_equals_one_device_engine(runs):
    assert runs["grid"][0]["tokens"] == [c.tokens for c in runs["one"]]


def test_layernorm_gelu_grid_equals_one_device_engine(runs):
    """layer_norm's two column sums, the gelu MLP and its column-sliced
    biases: the grid's tokens and logits are the one-device engine's."""
    pe0 = runs["ln_grid"][0]
    assert pe0["tokens"] == [c.tokens for c in runs["ln_one"]]
    assert set(pe0["rows"]) == set(runs["ln_rows"])
    for k, want in runs["ln_rows"].items():
        np.testing.assert_allclose(pe0["rows"][k], want, rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))


def test_heap_traffic_is_the_reckoned_count(runs):
    reports = runs["grid"]
    hq, kvh = JCFG.n_heads // 2, JCFG.n_kv_heads // 2
    got = heap_bytes_by_step(reports)
    names = [s["name"] for s in reports[0]["grid_log"]]
    assert all([s["name"] for s in r["grid_log"]] == names for r in reports)
    want = [reckoned_heap_bytes(runs["tcfg"], PLAN, n, hq, kvh)
            for n in names]
    assert got == want
    # one collective per reckoned message, on every PE
    n_msgs = [len(grid_messages(runs["tcfg"], PLAN, *step_shape(n)[:2],
                                hq=hq, kvh=kvh)) for n in names]
    for r in reports:
        assert [s["collectives"] for s in r["grid_log"]] == n_msgs


def test_every_pe_ran_the_kernels(runs):
    for r in runs["grid"]:
        n = r["launches"]
        steps = len(r["grid_log"])
        assert n.get("paged_attention_ref", 0) == steps * JCFG.n_layers
        assert n.get("shmem_put_ref", 0) > 0
        assert n.get("shmem_reduce_slots_ref", 0) > 0
        assert not any(k.endswith("_cuda") for k in n)


def test_shard_params_blocks(runs):
    gp, tcfg = runs["gp"], runs["tcfg"]
    full = from_jax_params(gp, tcfg, device="cpu")
    blocks = [shard_params(full, tcfg, PLAN, pe) for pe in range(4)]
    wq = full["layers"][0]["mixer"]["wq"]
    got = torch.cat([torch.cat([blocks[i * 2 + j]["layers"][0]["mixer"]["wq"]
                                for j in range(2)], -1) for i in range(2)], 1)
    assert torch.equal(got, wq)
    emb = torch.cat([torch.cat([blocks[i * 2 + j]["embed"] for j in range(2)],
                               -1) for i in range(2)], 0)
    assert torch.equal(emb, full["embed"])
    assert torch.equal(blocks[3]["layers"][0]["mixer"]["bq"],
                       full["layers"][0]["mixer"]["bq"])


def test_grid_engine_needs_its_pe_grid():
    with pytest.raises(ValueError, match="PE process"):
        ServingEngine(torch_config(JCFG), plan=PLAN,
                      engine_cfg=EngineConfig(device="cpu", **EC))
