"""The port's serving engine on SSM and hybrid models on a 2x2 grid of PE
processes against the JAX engine on a 2x2 grid.

The reduced mamba2-780m (one B/C group, fewer than the 2 grid columns: each
column takes the group its heads share) and the attention + mamba hybrid of
tests/test_torch_ssm.py (4 groups: each column takes 2) run in fp32 on a
2x2 mesh of 4 host devices, their weights drawn with numpy from seed 0;
the global weights go to four CPU PE processes (``serve_on_grid``), which
cut their blocks and serve the same requests.  Two batch slots serve more
requests than that, so slots are zeroed again for newcomers; each workload
is served twice, so the second pass adopts the dense prefix snapshots the
first published; and a page-free run preempts a running mamba2 request
(a higher-priority arrival under the ``fair_share`` policy) and restores
its dense snapshot.  Every one of PE 0's slot operations reaches the other
PEs as a command (zero, write, read, drop), which each applies to its own
shard.  Greedy tokens and every ``EngineStats`` counter must be JAX's,
the first two sampled tokens' logits within rel 1e-5, each step's heap
bytes the count reckoned from the shapes, and the SSD scan must run on
every PE.
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
from repro.serve.engine import EngineStats as JEngineStats
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.service.admission import make_policy as j_make_policy
from repro_torch.models.params import from_jax_params, shard_params
from repro_torch.partition import grid_plan
from repro_torch.serve.engine import EngineConfig, EngineStats, \
    SamplingParams
from repro_torch.serve.engine.grid import (GridJob, heap_bytes_by_step,
                                           reckoned_heap_bytes,
                                           serve_on_grid)

from test_torch_decode_fixed import init_numpy
from test_torch_ssm import HYBRID, torch_config

PLAN = grid_plan(2, 2)
CONFIGS = {"mamba2": reduced(get_config("mamba2-780m")), "hybrid": HYBRID}
EC = dict(s_max=32, buckets=(2,), block_pos_stride=4, prefill_chunks=(8,))
STATS = [f.name for f in dataclasses.fields(EngineStats)]
# the preemption run: two low-priority requests fill both slots, a
# high-priority one arrives at step 3 and preempts the younger
PREEMPT = dict(arrivals=[(0, 0), (0, 0), (3, 5)], admission="fair_share")


def _workload(vocab):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, size=n).tolist()
               for n in (9, 3, 14, 6, 11)]
    return prompts, [int(m) for m in (4, 6, 3, 5, 4)]


def _preempt_workload(vocab):
    rng = np.random.default_rng(6)
    return ([rng.integers(0, vocab, size=n).tolist() for n in (5, 7, 4)],
            [8, 8, 3])


def _jax_drain(jeng, prompts, sampling, arrivals, index):
    """The JAX engine's counterpart of ``ServingEngine.drain`` with
    arrivals, as PE 0 serves a job: prompt n submitted before step
    ``arrivals[n][0]`` with priority ``arrivals[n][1]``, an idle engine
    skipping ahead to the next arrival.  Returns the requests in prompt
    order."""
    n = len(prompts)
    arrivals = arrivals or [(0, 0)] * n
    order = sorted(range(n), key=lambda k: arrivals[k][0])
    reqs = [None] * n
    steps = 0
    while order or jeng.scheduler.has_work:
        while order and arrivals[order[0]][0] <= steps:
            k = order.pop(0)
            reqs[k] = jeng.submit(prompts[k], sampling[k],
                                  priority=arrivals[k][1])
            index[reqs[k].request_id] = k
        if not jeng.step():
            if not order:
                break
            steps = arrivals[order[0]][0]
            continue
        steps += 1
    jeng.queue.finish()
    return reqs


def _jax_serve(jeng, prompts, max_tokens, passes=1, record=2,
               arrivals=None):
    """Serve on the JAX engine as ``grid._serve`` serves on PE 0: per pass
    the tokens and stats, and the first pass's rows of each request's
    first ``record`` sampled tokens."""
    rows, index, sample = {}, {}, jeng._sample

    def sampled(req, row):
        k = (index[req.request_id], len(req.output_tokens))
        if k[1] < record:
            rows[k] = np.array(row)
        return sample(req, row)
    jeng._sample = sampled
    out = []
    sps = [JSamplingParams(max_tokens=m) for m in max_tokens]
    for _ in range(passes):
        jeng.stats = JEngineStats()
        reqs = _jax_drain(jeng, prompts, sps, arrivals, index)
        out.append(([list(r.output_tokens) for r in reqs],
                    dataclasses.asdict(jeng.stats)))
        record = 0
    del jeng._sample
    return out, rows


@pytest.fixture(scope="module")
def runs():
    mesh = jax.make_mesh((1, 4), (DATA, MODEL), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jplan = JMeshPlan((DATA, MODEL), (1, 4), 2, 2)
    jobs, gps, jax_engines = [], {}, {}
    for name, jcfg in CONFIGS.items():
        specs = param_specs(jcfg, 2, 2, preskew=False)
        host = init_numpy(specs, seed=0)
        jax_engines[name] = j_build_engine(
            jcfg, mesh, jplan, engine_cfg=JEngineConfig(**EC),
            params=jax.tree.map(lambda a, s: jax.device_put(
                a, NamedSharding(mesh, s)), host, pm.param_pspecs(specs)))
        gps[name] = jax.tree.map(np.asarray, gather_params(host, specs, 2, 2))
        prompts, mt = _workload(jcfg.vocab_size)
        jobs.append(GridJob(torch_config(jcfg), EngineConfig(
            device="cpu", **EC), prompts,
            [SamplingParams(max_tokens=m) for m in mt], weights=gps[name],
            record=2, passes=2))
    pp, pmt = _preempt_workload(CONFIGS["mamba2"].vocab_size)
    jobs.append(GridJob(torch_config(CONFIGS["mamba2"]), EngineConfig(
        device="cpu", **EC), pp, [SamplingParams(max_tokens=m) for m in pmt],
        weights=gps["mamba2"], record=2, **PREEMPT))
    with ThreadPoolExecutor(1) as ex:
        grid = ex.submit(serve_on_grid, jobs, PLAN, device="cpu",
                         timeout=120)
        want = {}
        for name, jeng in jax_engines.items():
            prompts, mt = _workload(CONFIGS[name].vocab_size)
            want[name] = _jax_serve(jeng, prompts, mt, passes=2)
        jeng = jax_engines["mamba2"]
        jeng.scheduler.admission = j_make_policy("fair_share")
        want["preempt"] = _jax_serve(jeng, pp, pmt,
                                     arrivals=PREEMPT["arrivals"])
        preempted = jeng.scheduler.n_preemptions
        reports = grid.result()
    return dict(grid=dict(zip(["mamba2", "hybrid", "preempt"], reports)),
                want=want, gps=gps, jax_preemptions=preempted)


@pytest.mark.parametrize("run", ["mamba2", "hybrid", "preempt"])
def test_tokens_and_stats_match_jax_engine(runs, run):
    pe0 = runs["grid"][run][0]
    (want_passes, _) = runs["want"][run]
    assert len(pe0["passes"]) == len(want_passes)
    for got, (tokens, stats) in zip(pe0["passes"], want_passes):
        assert got["tokens"] == tokens
        assert {k: got["stats"][k] for k in STATS} == \
            {k: stats[k] for k in STATS}


@pytest.mark.parametrize("run", ["mamba2", "hybrid", "preempt"])
def test_first_two_tokens_logits_match_jax(runs, run):
    rows, jrows = runs["grid"][run][0]["rows"], runs["want"][run][1]
    assert set(rows) == set(jrows) and any(k[1] == 1 for k in rows)
    for k, want in jrows.items():
        np.testing.assert_allclose(rows[k], want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_every_state_command_reaches_every_pe(runs):
    """Slots zeroed for newcomers, prefix snapshots read and adopted in
    the second pass, the preempted request's snapshot read, written back
    and dropped: PE 0 logged each, and the other PEs applied the same."""
    for run, kinds in (("mamba2", {"zero", "read", "write"}),
                       ("hybrid", {"zero", "read", "write"}),
                       ("preempt", {"zero", "read", "write", "drop"})):
        reports = runs["grid"][run]
        logged = reports[0]["state_commands"]
        assert kinds <= set(logged), (run, logged)
        for r in reports[1:]:
            assert r["state_commands"] == logged, (run, r["pe"])
    assert runs["jax_preemptions"] == 1
    assert runs["grid"]["preempt"][0]["stats"]["prompt_tokens_ingested"] \
        == sum(len(p) for p in _preempt_workload(
            CONFIGS["mamba2"].vocab_size)[0])


@pytest.mark.parametrize("run", ["mamba2", "hybrid", "preempt"])
def test_heap_traffic_is_the_reckoned_count(runs, run):
    reports = runs["grid"][run]
    cfg = torch_config(CONFIGS["mamba2" if run == "preempt" else run])
    hq = cfg.heads_padded(2) // 2 if cfg.n_heads else 0
    kvh = cfg.kv_stored(2)[0] // 2 if cfg.n_heads else 0
    got = heap_bytes_by_step(reports)
    want = [reckoned_heap_bytes(cfg, PLAN, s["name"], hq, kvh)
            for s in reports[0]["grid_log"]]
    assert got == want


def test_every_pe_ran_the_scan(runs):
    for run in ("mamba2", "hybrid", "preempt"):
        for r in runs["grid"][run]:
            n = r["launches"]
            chunks = sum(s["name"].startswith("prefill")
                         for s in r["grid_log"])
            jcfg = CONFIGS["mamba2" if run == "preempt" else run]
            n_mamba = jcfg.n_groups() * sum(m == "mamba"
                                            for m, _ in jcfg.pattern())
            assert chunks > 0
            assert n.get("ssd_chunk_ref", 0) == chunks * n_mamba, (run, n)
            assert n.get("shmem_put_ref", 0) > 0
            assert not any(k.endswith("_cuda") for k in n)


def test_shard_params_cuts_mamba_leaves(runs):
    """wz..wo blocked (K/q, N/r) in natural position, the conv, decay,
    skip and norm leaves whole on every PE."""
    cfg = torch_config(HYBRID)
    full = from_jax_params(runs["gps"]["hybrid"], cfg, device="cpu")
    blocks = [shard_params(full, cfg, PLAN, pe) for pe in range(4)]
    for name in ("wz", "wx", "wb", "wc", "wdt", "wo"):
        want = full["layers"][1]["mixer"][name]
        got = torch_cat_blocks([b["layers"][1]["mixer"][name]
                                for b in blocks])
        assert np.array_equal(got, want.numpy()), name
    for name in ("conv_w", "conv_b", "A", "dt_bias", "D", "ssm_norm"):
        for b in blocks:
            assert np.array_equal(b["layers"][1]["mixer"][name].numpy(),
                                  full["layers"][1]["mixer"][name].numpy())


def torch_cat_blocks(blocks):
    """Reassemble (G, K/2, N/2) blocks of a 2x2 grid into (G, K, N)."""
    rows = [np.concatenate([blocks[i * 2 + j].numpy() for j in range(2)],
                           axis=-1) for i in range(2)]
    return np.concatenate(rows, axis=-2)
