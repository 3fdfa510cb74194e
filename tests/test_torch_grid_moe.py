"""The port's serving engine on MoE models on a 2x2 grid of PE processes
against the JAX engine on a 2x2 grid.

The reduced qwen3-moe-235b-a22b (16 experts, 4 a PE, top-2; the reduced
jamba is in tests/test_torch_grid_jamba.py) runs in fp32 on a 2x2 mesh of
4 host devices, its weights drawn with numpy from seed 0; four CPU PE
processes cut their blocks of the same global weights (``shard_params``: experts over the flat PE space) and serve
the same requests (``serve_on_grid``), dispatching and combining through
``PeGrid.all_to_all`` on the shared-memory heaps.  Capacity is per owner PE,
``ceil(T k / 4 * capacity_factor)``: qwen3-moe runs at the reduced config's
2.0, at 0.5 (where both packages drop pairs, the same ones), and with the
int8 wire (codes and fp32 scales on the heap).  Greedy
tokens and every ``EngineStats`` counter must be JAX's, the first two
sampled tokens' logits within rel 1e-4 (max abs difference over max abs
value, as tests/test_torch_moe_engine.py holds them), and each step's heap
bytes the count reckoned from the shapes.  At ``capacity_factor`` 4 (=
n_pes, so cap = T k and nothing can drop) the grid's tokens are the port's
one-device engine's.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.models.transformer import param_specs
from repro.partition import DATA, MODEL
from repro.partition import MeshPlan as JMeshPlan
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro_torch.models.params import from_jax_params, shard_params
from repro_torch.partition import grid_plan
from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                      SamplingParams, build_engine, generate)
from repro_torch.serve.engine.grid import (GridJob, heap_bytes_by_step,
                                           reckoned_heap_bytes, serve_on_grid)

from test_torch_decode_fixed import init_numpy
from test_torch_grid_ssm import _jax_serve
from test_torch_ssm import torch_config

PLAN = grid_plan(2, 2)
QWEN = reduced(get_config("qwen3-moe-235b-a22b"))
CONFIGS = {
    "qwen3-moe": QWEN,
    "qwen3-moe drops": dataclasses.replace(QWEN, capacity_factor=0.5),
    "qwen3-moe int8": dataclasses.replace(QWEN, moe_wire_dtype="int8"),
}
NO_DROP = dataclasses.replace(QWEN, capacity_factor=4.0)
EC = dict(s_max=32, buckets=(2,), block_pos_stride=4, prefill_chunks=(8,))
STATS = [f.name for f in dataclasses.fields(EngineStats)]
LOGIT_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def _workload(vocab):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (9, 3, 13)]
    return prompts, [4, 5, 3]


def serve_both(configs, extra=()):
    """Each config (all on one set of weights, those of the first) served
    by the JAX engine at 2x2 and by the port on four CPU PEs, and the
    ``extra`` configs by the port alone on the same weights.  Returns the
    per-config PE reports, JAX's (tokens, stats) and rows, the weights,
    and the port's one-device tokens for the last extra config."""
    mesh = jax.make_mesh((1, 4), (DATA, MODEL), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jplan = JMeshPlan((DATA, MODEL), (1, 4), 2, 2)
    first = next(iter(configs.values()))
    specs = param_specs(first, 2, 2, preskew=False)
    host = init_numpy(specs, seed=0)
    gp = jax.tree.map(np.asarray, gather_params(host, specs, 2, 2))
    prompts, mt = _workload(first.vocab_size)
    sampling = [SamplingParams(max_tokens=m) for m in mt]
    jobs = [GridJob(torch_config(c), EngineConfig(device="cpu", **EC),
                    prompts, sampling, weights=gp, record=2)
            for c in list(configs.values()) + list(extra)]
    with ThreadPoolExecutor(1) as ex:
        grid = ex.submit(serve_on_grid, jobs, PLAN, device="cpu",
                         timeout=120)
        want = {}
        for name, jcfg in configs.items():
            jeng = j_build_engine(
                jcfg, mesh, jplan, engine_cfg=JEngineConfig(**EC),
                params=jax.tree.map(lambda a, s: jax.device_put(
                    a, NamedSharding(mesh, s)), host,
                    pm.param_pspecs(specs)))
            want[name] = _jax_serve(jeng, prompts, mt)
        ones = None
        if extra:
            cfg = torch_config(extra[-1])
            one = build_engine(cfg, params=from_jax_params(
                gp, cfg, device="cpu"),
                engine_cfg=EngineConfig(device="cpu", **EC))
            ones = [c.tokens for c in generate(one, prompts, sampling)]
        reports = grid.result()
    names = list(configs) + [f"extra {k}" for k in range(len(extra))]
    return dict(grid=dict(zip(names, reports)), want=want, one=ones, gp=gp)


@pytest.fixture(scope="module")
def runs():
    out = serve_both(CONFIGS, extra=[NO_DROP])
    out["grid"]["no drop"] = out["grid"].pop("extra 0")
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tokens_and_stats_match_jax_engine(runs, name):
    pe0 = runs["grid"][name][0]
    ((tokens, stats),), _ = runs["want"][name]
    assert pe0["tokens"] == tokens
    assert {k: pe0["stats"][k] for k in STATS} == \
        {k: stats[k] for k in STATS}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_first_two_tokens_logits_match_jax(runs, name):
    rows, jrows = runs["grid"][name][0]["rows"], runs["want"][name][1]
    assert set(rows) == set(jrows) and any(k[1] == 1 for k in rows)
    for k, want in jrows.items():
        assert _rel(want, rows[k]) < LOGIT_TOL, k


def test_capacity_drops_only_where_it_must(runs):
    """Every PE routes alike, so every PE counts the same pairs; at cf 0.5
    some drop, at cf 4 none can."""
    for name in ("qwen3-moe drops", "no drop"):
        reports = runs["grid"][name]
        assert len({(r["moe_pairs"], r["moe_dropped"])
                    for r in reports}) == 1
        pairs, dropped = reports[0]["moe_pairs"], reports[0]["moe_dropped"]
        assert pairs > 0
        assert (dropped > 0) == (name == "qwen3-moe drops"), (name, dropped)


def test_no_drop_grid_equals_one_device_engine(runs):
    assert runs["grid"]["no drop"][0]["tokens"] == runs["one"]


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["no drop"])
def test_heap_traffic_is_the_reckoned_count(runs, name):
    reports = runs["grid"][name]
    cfg = torch_config(CONFIGS.get(name, NO_DROP))
    hq, kvh = cfg.heads_padded(2) // 2, cfg.kv_stored(2)[0] // 2
    got = heap_bytes_by_step(reports)
    want = [reckoned_heap_bytes(cfg, PLAN, s["name"], hq, kvh)
            for s in reports[0]["grid_log"]]
    assert got == want
    # the flat exchange reserved n_pes slots a half
    assert reports[0]["heap_bytes"] == 2 * 4 * reports[0]["heap_slot_bytes"]


def test_every_pe_ran_the_experts(runs):
    for name in list(CONFIGS) + ["no drop"]:
        cfg = CONFIGS.get(name, NO_DROP)
        n_moe = cfg.n_groups() * sum(f == "moe" for _, f in cfg.pattern())
        for r in runs["grid"][name]:
            n, steps = r["launches"], len(r["grid_log"])
            assert n.get("grouped_mm_ref", 0) == steps * n_moe, (name, n)
            assert n.get("grouped_mm_swiglu_ref", 0) == steps * n_moe
            assert not any(k.endswith("_cuda") for k in n)


def test_shard_params_cuts_experts_over_the_flat_pe_space(runs):
    cfg = torch_config(QWEN)
    full = from_jax_params(runs["gp"], cfg, device="cpu")
    blocks = [shard_params(full, cfg, PLAN, pe) for pe in range(4)]
    for name in ("w1", "w2"):
        got = np.concatenate([b["layers"][0]["ffn"][name].numpy()
                              for b in blocks], axis=1)
        assert np.array_equal(got, full["layers"][0]["ffn"][name].numpy())
    for b in blocks:
        assert np.array_equal(b["layers"][0]["ffn"]["router"].numpy(),
                              full["layers"][0]["ffn"]["router"].numpy())
