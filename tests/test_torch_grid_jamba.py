"""The reduced jamba-1.5-large-398b on a 2x2 grid of PE processes against
the JAX engine on a 2x2 grid: attention (paged over the grid rows), mamba
(4 B/C groups, 2 a column) and MoE layers (16 experts, 4 a PE, capacity
per owner PE at the reduced 2.0) in one pattern of 8, in fp32, on the
weights and requests of tests/test_torch_grid_moe.py's helper.  Greedy
tokens and every ``EngineStats`` counter must be JAX's, the first two
sampled tokens' logits within rel 1e-4, each step's heap bytes the count
reckoned from the shapes, and every PE must have run the paged attention,
the SSD scan and the grouped GEMMs on every layer of its kind.
"""

import dataclasses

import pytest

from repro.configs import get_config
from repro.configs.registry import reduced
from repro_torch.serve.engine import EngineStats
from repro_torch.serve.engine.grid import (heap_bytes_by_step,
                                           reckoned_heap_bytes)

from test_torch_grid_moe import LOGIT_TOL, PLAN, _rel, serve_both
from test_torch_ssm import torch_config

JAMBA = reduced(get_config("jamba-1.5-large-398b"))
STATS = [f.name for f in dataclasses.fields(EngineStats)]


@pytest.fixture(scope="module")
def runs():
    return serve_both({"jamba": JAMBA})


def test_tokens_and_stats_match_jax_engine(runs):
    pe0 = runs["grid"]["jamba"][0]
    ((tokens, stats),), _ = runs["want"]["jamba"]
    assert pe0["tokens"] == tokens
    assert {k: pe0["stats"][k] for k in STATS} == \
        {k: stats[k] for k in STATS}


def test_first_two_tokens_logits_match_jax(runs):
    rows, jrows = runs["grid"]["jamba"][0]["rows"], runs["want"]["jamba"][1]
    assert set(rows) == set(jrows) and any(k[1] == 1 for k in rows)
    for k, want in jrows.items():
        assert _rel(want, rows[k]) < LOGIT_TOL, k


def test_heap_traffic_is_the_reckoned_count(runs):
    reports = runs["grid"]["jamba"]
    cfg = torch_config(JAMBA)
    hq, kvh = cfg.heads_padded(2) // 2, cfg.kv_stored(2)[0] // 2
    got = heap_bytes_by_step(reports)
    assert got == [reckoned_heap_bytes(cfg, PLAN, s["name"], hq, kvh)
                   for s in reports[0]["grid_log"]]


def test_every_pe_ran_every_kernel_of_the_pattern(runs):
    kinds = {k: JAMBA.n_groups() * sum(v == k for pair in JAMBA.pattern()
                                       for v in pair)
             for k in ("attn", "mamba", "moe")}
    for r in runs["grid"]["jamba"]:
        n, log = r["launches"], r["grid_log"]
        steps = len(log)
        chunks = sum(s["name"].startswith("prefill") for s in log)
        assert n.get("paged_attention_ref", 0) == steps * kinds["attn"]
        assert n.get("ssd_chunk_ref", 0) == chunks * kinds["mamba"] > 0
        assert n.get("grouped_mm_ref", 0) == steps * kinds["moe"] > 0
        assert not any(k.endswith("_cuda") for k in n)
