"""The fixed-batch ``batched`` decode on a 2x2 grid of PE processes against
the JAX package's at 2x2, and the launcher that runs it.

``make_decode_step(mode="batched")``: the batch over the grid rows (each
PE's cache holds its row's slots and its column's kv heads, conv channels
and SSM heads), every projection a Cannon GEMM on pre-skewed blocks, no
communication in attention, the logits gathered over the columns and the
rows.  The dense, ssm and moe configs of tests/test_model_equivalence.py
(moe at capacity factor 16: nothing drops) decode 8 greedy tokens from one
random token a row, batch 8 (4 a row), ``s_max`` 16: JAX under
``shard_map`` on 4 host devices, the port on four CPU PE processes (one
spawn) on the same global weights.  Gates: every PE's tokens equal to
JAX's, each step's logits within rel 1e-5, each step's heap bytes the
reckoned count, and ``launch/serve.py --mode batched --grid 2x2 --device
cpu --smoke`` end to end.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.models.ref import gather_params
from repro.partition import DATA
from repro.serve.decode import cache_pspecs
from repro.serve.decode import cache_specs as j_cache_specs
from repro.serve.decode import make_decode_step as j_make_decode_step
from repro_torch.launch.grid_run import DecodeJob, run_on_grid

from test_model_equivalence import CFGS
from test_torch_decode_fixed import torch_config
from test_torch_grid_forward import (PLAN, TOL, init_varied, jax_mesh,
                                     jax_plan, place, rel)

NAMES = ("dense", "ssm", "moe")
B, S_MAX, STEPS = 8, 16, 8


def jax_decode(jcfg, first):
    """JAX's greedy tokens (B, STEPS + 1) and each step's logits, and the
    global weights."""
    mesh, plan = jax_mesh(), jax_plan()
    step, specs, pctx = j_make_decode_step(jcfg, mesh, plan, batch=B,
                                           s_max=S_MAX, mode="batched")
    host = init_varied(specs, seed=0)
    params = place(mesh, host, specs)
    cache = jax.tree.map(
        lambda sd, sp: jax.device_put(jnp.zeros(sd.shape, sd.dtype),
                                      NamedSharding(mesh, sp)),
        j_cache_specs(jcfg, plan, B, S_MAX, "batched"),
        cache_pspecs(jcfg, "batched", pctx.data_axes))
    tok = np.asarray(first, np.int32)
    toks, rows = [tok], []
    for t in range(STEPS):
        logits, cache = step(params, cache, jax.device_put(
            jnp.asarray(tok), NamedSharding(mesh, P(DATA))), t)
        rows.append(np.asarray(logits)[:, 0])
        tok = np.argmax(rows[-1][:, :jcfg.vocab_size], -1).astype(np.int32)
        toks.append(tok)
    return {"tokens": np.stack(toks, 1), "rows": rows,
            "weights": jax.tree.map(np.asarray,
                                    gather_params(host, specs, 2, 2))}


@pytest.fixture(scope="module")
def runs():
    want, jobs = {}, []
    for n, name in enumerate(NAMES):
        jcfg = CFGS[name]
        first = np.random.default_rng(n).integers(0, jcfg.vocab_size, B)
        want[name] = jax_decode(jcfg, first)
        jobs.append(DecodeJob(torch_config(jcfg), first, s_max=S_MAX,
                              steps=STEPS, weights=want[name]["weights"],
                              record=STEPS))
    got = run_on_grid(jobs, PLAN, device="cpu", timeout=120)
    return want, dict(zip(NAMES, got))


@pytest.mark.parametrize("name", NAMES)
def test_tokens_equal_jax(runs, name):
    want, got = runs
    for r in got[name]:
        np.testing.assert_array_equal(r["tokens"], want[name]["tokens"],
                                      err_msg=f"{name} PE {r['pe']}")


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_jax(runs, name):
    want, got = runs
    for r in got[name]:
        for t, (w, g) in enumerate(zip(want[name]["rows"], r["rows"])):
            assert rel(w, g) < TOL, (name, r["pe"], t)


@pytest.mark.parametrize("name", NAMES)
def test_heap_bytes_per_step_are_reckoned(runs, name):
    _, got = runs
    for r in got[name]:
        assert [s["heap_bytes"] for s in r["steps"]] == \
            [r["reckoned_heap_bytes"]] * STEPS


def test_launcher_batched_grid_on_the_cpu():
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-0.5b", "--mode", "batched", "--grid", "2x2", "--device",
         "cpu", "--smoke", "--tokens", "4", "--batch", "4"],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "2x2 grid" in res.stdout and "heap bytes" in res.stdout
    assert "equal" in res.stdout, res.stdout


def test_launcher_refuses_other_modes_on_a_grid():
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-0.5b", "--mode", "gemv", "--grid", "2x2", "--device", "cpu",
         "--smoke"], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0
    assert "later slice" in res.stderr + res.stdout
