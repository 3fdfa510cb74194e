"""The blocked forward of the SSM, MoE and hybrid configs on a 2x2 grid of
PE processes against the JAX package's at 2x2.

The moe, ssm and hybrid configs of tests/test_model_equivalence.py
(hybrid: attention + MLP and mamba + MoE layers, 4 B/C groups over the 2
columns; ssm: 1 group, which the 2 columns share), the SSM ones at
``ssd_chunk`` 16 on 64 positions, so each grid row scans two chunks of
its 32 and the cross-row state relay carries the state of row 0 into row
1.  JAX runs its jnp paths under ``shard_map`` on 4 host devices; the
port's four CPU PE processes (one spawn) run ``make_loss_fn`` under cannon
and cannon_opt and ``make_prefill`` under cannon on the same global
weights, drawn with numpy in each strategy's storage.  MoE capacity
factor 16: nothing drops on either side, so the load-balance aux (summed
over the rows before its product) enters both losses alike.

Gates: the loss within rel 1e-5 of JAX's on every PE, the prefill's
last-position logits within rel 1e-5, the heap bytes reckoned, and the
SSD scan's two passes (their plain versions here) launched once per mamba
layer of every forward on every PE.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.launch.grid_run import ForwardJob, make_batch, run_on_grid

from test_model_equivalence import CFGS
from test_torch_decode_fixed import torch_config
from test_torch_grid_forward import PLAN, TOL, jax_forward, rel

CHUNK = 16
CONFIGS = {name: dataclasses.replace(CFGS[name], ssd_chunk=CHUNK)
           for name in ("moe", "ssm", "hybrid")}
CASES = [(n, s) for n in CONFIGS for s in ("cannon", "cannon_opt")]
PREFILL = ("ssm", "hybrid")


def _mamba_layers(cfg):
    return cfg.n_groups() * sum(m == "mamba" for m, _ in cfg.pattern())


@pytest.fixture(scope="module")
def runs():
    want, jobs = {}, []
    for name, strategy in CASES:
        jcfg = CONFIGS[name]
        toks, labels = make_batch(jcfg, 2, 64, seed=2)
        want[name, strategy] = jax_forward(
            jcfg, strategy, toks, labels,
            prefill=strategy == "cannon" and name in PREFILL)
        jobs.append(ForwardJob(torch_config(jcfg), strategy, toks, labels,
                               weights=want[name, strategy]["weights"]))
    got = run_on_grid(jobs, PLAN, device="cpu", timeout=120)
    return want, dict(zip(CASES, got))


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_loss_matches_jax(runs, case):
    want, got = runs
    for r in got[case]:
        assert rel(want[case]["loss"], r["loss"]) < TOL, (case, r["pe"])
        for what in ("loss", "prefill"):
            assert r[f"{what}_runs"][0]["heap_bytes"] == \
                r["reckoned_heap_bytes"][what], (case, what)


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_logits_match_jax(runs, name):
    want, got = runs
    w = want[name, "cannon"]["logits"]
    for r in got[name, "cannon"]:
        assert rel(w, r["logits"]) < TOL, (name, r["pe"])


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in PREFILL],
                         ids=lambda c: "-".join(c))
def test_scan_passes_run_on_every_mamba_layer(runs, case):
    _, got = runs
    n = _mamba_layers(CONFIGS[case[0]])
    for r in got[case]:
        for what in ("loss", "prefill"):
            counts = r[f"{what}_runs"][0]["launches"]
            assert counts["ssd_chunk_ref"]["launches"] == n, (what, counts)
            assert counts["ssd_apply_ref"]["launches"] == n, (what, counts)
