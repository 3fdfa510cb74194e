"""Checkpoints, resume and the fault drill of a training run on a 2x2
grid of PE processes, against the JAX package's files of the same grid.

One spawn of four CPU PE processes runs seven jobs of the dense config of
``tests/test_model_equivalence.py`` (``launch/grid_run.py::TrainJob``
under the training controller, on the batches of the data pipeline that
``tests/test_torch_grid_train.py::batches`` takes, at that file's OPT and
on its ``init_tied`` weights):

* under cannon, fp32 moments and 8-bit: a straight run of five steps that
  checkpoints after step 2 (``ckpt_every`` 3), a drill whose step 3 fails
  on every attempt, so it stops past its retry budget with the step-2
  checkpoint, and a run that resumes from that checkpoint;
* under cannon_opt, fp32 moments: three steps and their checkpoint.

JAX runs the same three steps at 2x2 on 4 host devices and writes them
with ``jax_ckpt.save``.  Held: the port's step-2 files against JAX's leaf
for leaf (paths, shapes, dtypes and order; parameter blocks within 2e-5
as in ``test_torch_grid_train.py``; moments within MOMENT_TOL); PE p's
8-bit rows against ``addressable_shards[p]`` of JAX's leaf, for a leaf
stacked over layer groups (which JAX's own file holds PE 0's rows of
only, ROADMAP section 3) and for ``embed``; the resumed steps against the
straight run's losses and final blocks bit for bit; the 1x1 port's loss
on the grid checkpoint against the grid's next step (rel 1e-5, the loss
bound of the grid tests); 8-bit moments refused on another grid, naming
both.

Without a spawn: the stored form of a 4x4 grid assembled from the 16
PEs' ``shard_params`` blocks against JAX's stored tree of a 16-device
plan, in each storage, for the ``blocked2d``, ``vocab2d`` and
``expert_flat`` leaves of the hybrid config, and read back per PE and at
1x1 (at q = 2 a block index skewed the wrong way round reads the same).

The same spawn serves a reduced qwen2-0.5b engine's job
(``run_on_grid`` takes the engine's ``GridJob`` as ``serve_on_grid``
does, as ``chip_smoke.py``'s grid phases share one spawn).

The launchers: ``launch/train.py --grid 2x2 --device cpu`` stops at
``--fail-at-step`` with a non-zero exit and resumes from the checkpoint
it left (always with ``--ckpt-dir`` a fresh directory: the default one
may hold a stale checkpoint); ``launch/serve.py --grid`` refuses
``--service`` and ``--supervised``.  A drill whose injector fails on one
PE alone raises ``CollectiveMismatch`` on the grid, not a hang.
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.ckpt import checkpoint as jax_ckpt
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.models.transformer import param_specs
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_state as jax_init_state
from repro.optim.adamw import state_pspecs
from repro.train.step import make_train_step as j_train_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.grid_run import TrainJob, run_on_grid
from repro_torch.models.params import from_jax_params, shard_params
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.partition import grid_plan
from repro_torch.runtime.fault_tolerance import mismatch_drill
from repro_torch.runtime.pe import PeFailed, run_pes
from repro_torch.serve.engine import EngineConfig, SamplingParams
from repro_torch.serve.engine.grid import GridJob
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS
from test_torch_decode_fixed import init_numpy, torch_config
from test_torch_grid_forward import jax_mesh, jax_plan, place
from test_torch_grid_train import OPT, PLAN, _rel, batches, init_tied

JCFG = CFGS["dense"]
CFG = torch_config(JCFG)
DATA = DataConfig(128, 64, 2)          # batches() of the grid train tests
STEPS, EVERY, FAIL = 5, 3, 3           # checkpoint after step 2
# the moments after three steps, against JAX's, relative to each leaf's
# largest magnitude: they are sums of gradients that the grid reduces in
# another order than XLA (slot-order psums), the same differences the
# parameter blocks' 2e-5 bound takes; the second moment squares them
MOMENT_TOL = 1e-4


def jax_setup(strategy, bits):
    """JAX's step at 2x2 and ``init_tied``'s weights for it."""
    mesh, plan = jax_mesh(), jax_plan()
    opt = JaxAdamW(**OPT, state_bits=bits)
    fn, specs, _ = j_train_step(JCFG, mesh, plan, opt_cfg=opt,
                                tp_strategy=strategy, remat=True,
                                donate=False)
    host = init_tied(specs)
    return dict(mesh=mesh, opt=opt, fn=fn, specs=specs, host=host,
                start=jax.tree.map(np.asarray,
                                   gather_params(host, specs, 2, 2)))


def jax_steps(setup):
    """JAX's three steps from the setup's weights: (params, opt state)."""
    mesh, specs, opt = setup["mesh"], setup["specs"], setup["opt"]
    p = place(mesh, setup["host"], specs)
    o = jax_init_state(p, opt)
    o = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                     o, state_pspecs(pm.param_pspecs(specs), opt))
    for toks, labels in batches():
        p, o, _ = setup["fn"](p, o, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    return p, o


def job(strategy, weights, root, name, bits=32, steps=STEPS, **kw):
    return TrainJob(CFG, strategy, data=DATA, steps=steps, weights=weights,
                    opt=dict(OPT, state_bits=bits),
                    ckpt_dir=os.path.join(root, name), ckpt_every=EVERY,
                    return_params=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's jobs in one spawn, while JAX runs its steps beside it:
    (the directory, JAX's setups and results, the jobs' reports)."""
    root = str(tmp_path_factory.mktemp("grid_ckpt"))
    setups = {key: jax_setup(*key) for key in
              (("cannon", 32), ("cannon_opt", 32), ("cannon", 8))}
    w = setups["cannon", 32]["start"]
    jobs = {}
    for bits in (32, 8):
        jobs[f"straight{bits}"] = job("cannon", w, root, f"straight{bits}",
                                      bits)
        jobs[f"drill{bits}"] = job("cannon", w, root, f"drill{bits}", bits,
                                   fail_at_step=FAIL)
        jobs[f"resumed{bits}"] = job("cannon", w, root, f"drill{bits}", bits)
    jobs["opt"] = job("cannon_opt", setups["cannon_opt", 32]["start"], root,
                      "straight_opt", steps=3)
    # a serving job in the same spawn, as chip_smoke.py's grid phases run
    jobs["serve"] = GridJob(
        reduced(get_config("qwen2-0.5b")),
        EngineConfig(device="cpu", s_max=32, buckets=(4,),
                     block_pos_stride=4), [[1, 2, 3], [4, 5, 6, 7, 8]],
        SamplingParams(max_tokens=3), seed=0)
    with ThreadPoolExecutor(1) as ex:
        grid = ex.submit(run_on_grid, list(jobs.values()), PLAN,
                         device="cpu", timeout=120)
        jx = {}
        for (strategy, bits), setup in setups.items():
            p, o = jx[strategy, bits] = jax_steps(setup)
            jax_ckpt.save(os.path.join(root, f"jax_{strategy}_{bits}"), 2,
                          {"params": p, "opt": o})
        got = grid.result()
    return root, setups, jx, dict(zip(jobs, got))


def _files(d):
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    return man, [np.load(os.path.join(d, e["file"])) for e in man["leaves"]]


@pytest.mark.parametrize("strategy,name", [("cannon", "straight32"),
                                           ("cannon_opt", "straight_opt")])
def test_grid_files_match_jax(runs, strategy, name):
    root, _, _, _ = runs
    want_man, want = _files(os.path.join(root, f"jax_{strategy}_32",
                                         "step_00000002"))
    man, got = _files(os.path.join(root, name, "step_00000002"))
    assert [(e["path"], e["shape"], e["dtype"]) for e in man["leaves"]] \
        == [(e["path"], e["shape"], e["dtype"]) for e in want_man["leaves"]]
    assert man["step"] == want_man["step"] == 2
    assert man["meta"] == {"grid": [2, 2], "moments": "local_shards",
                           "storage": {"cannon": True,
                                       "cannon_opt": "opt"}[strategy]}
    for e, a, b in zip(man["leaves"], want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, e["path"]
        err = float(np.abs(a.astype(np.float64) - b).max())
        if e["path"].startswith("['params']"):
            assert err <= 2e-5, (e["path"], err)
        elif e["path"].endswith(".dense"):
            assert err <= MOMENT_TOL * float(np.abs(a).max()), \
                (e["path"], err)
        else:
            assert np.array_equal(a, b), e["path"]     # the step


@pytest.mark.parametrize("leaf", [("layers", 0, "ffn", "w_down"),
                                  ("embed",)])
def test_8bit_rows_are_each_pe_s_shard(runs, leaf):
    """PE p's codes and scales in the port's file are JAX's device-p
    shard: codes within one (a flipped rounding), scales (a block's
    largest moment / 127) within MOMENT_TOL of the shard's largest."""
    root, setups, jx, _ = runs
    _, o = jx["cannon", 8]
    mesh = setups["cannon", 8]["mesh"]
    man, got = _files(os.path.join(root, "straight8", "step_00000002"))
    files = {e["path"]: a for e, a in zip(man["leaves"], got)}
    for moment in ("m", "v"):
        node = o[moment]
        for k in leaf:
            node = node[k]
        path = "/".join([f"['opt']/['{moment}']"] + [
            f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in leaf])
        for field in ("q", "scale"):
            arr = getattr(node, field)
            shards = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            rows = files[f"{path}/.{field}"]
            n = rows.shape[0] // PLAN.n_pes
            assert rows.shape[0] == PLAN.n_pes * n
            for pe, dev in enumerate(mesh.devices.flat):
                mine, theirs = rows[pe * n:(pe + 1) * n], shards[dev]
                assert mine.shape == theirs.shape, (path, pe)
                if field == "q":
                    assert int(np.abs(mine.astype(np.int32)
                                      - theirs).max()) <= 1, (path, pe)
                else:
                    err = float(np.abs(mine - theirs).max())
                    assert err <= MOMENT_TOL * float(np.abs(theirs).max()), \
                        (path, pe, err)


@pytest.mark.parametrize("bits", [32, 8])
def test_stopped_run_resumes_to_the_straight_run(runs, bits):
    _, _, _, got = runs
    straight, drill, resumed = (got[f"{k}{bits}"] for k in
                                ("straight", "drill", "resumed"))
    for s, d, r in zip(straight, drill, resumed):
        assert [x["step"] for x in s["steps"]] == list(range(STEPS))
        assert s["checkpoints"][0]["step"] == 2 and s["stopped_at"] is None
        assert d["stopped_at"] == FAIL and d["retries"] == 3
        assert d["ckpt_step"] == 2 and len(d["steps"]) == FAIL
        assert r["start_step"] == FAIL and r["restored"]["step"] == 2
        loss = {x["step"]: x["loss"] for x in s["steps"]}
        assert [x["loss"] for x in d["steps"]] == [loss[k] for k in
                                                   range(FAIL)]
        assert [(x["step"], x["loss"]) for x in r["steps"]] == \
            [(k, loss[k]) for k in range(FAIL, STEPS)]
        for p in s["params"]:
            assert np.array_equal(s["params"][p], r["params"][p]), p
        assert s["steps"][0]["loss"] == straight[0]["steps"][0]["loss"]


def test_a_serving_job_shares_the_spawn(runs):
    """``run_on_grid`` serves an engine's job as ``serve_on_grid`` does:
    PE 0 serves, the others follow every step."""
    _, _, _, got = runs
    pe0 = got["serve"][0]
    assert pe0["finish"] == ["length", "length"]
    assert [len(t) for t in pe0["tokens"]] == [3, 3]
    assert {len(r["grid_log"]) for r in got["serve"]} == \
        {len(pe0["grid_log"])}
    assert all(r["heap"] == "CpuHeap" for r in got["serve"])


def test_heap_kernels_as_reckoned(runs):
    """Every step's heap kernels (their plain versions on the CPU): one
    put a message's peer, one reduction a sum, reduce-scatter or gather
    transpose (``grid_run.heap_launches`` of ``train_messages``)."""
    _, _, _, got = runs
    for r in got["straight32"] + got["resumed8"]:
        want = {f"{k}_ref": n for k, n in r["reckoned_heap_launches"].items()}
        for rec in r["steps"]:
            n = {k: c["launches"] for k, c in rec["launches"].items()}
            assert {k: n.get(k, 0) for k in want} == want, (r["pe"], rec)


def test_one_device_reads_the_grid_checkpoint(runs):
    root, _, _, got = runs
    d = os.path.join(root, "straight32")
    step, params, opt = ckpt.restore_train_state(d, q=2, r=2, storage=True)
    assert step == 2 and int(opt["step"]) == 3
    _, params_meta, _ = ckpt.restore_train_state(d)   # the grid from meta
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                 leaves(params_meta)))
    b = {k: torch.from_numpy(v) for k, v in
         ckpt_batch(3).items()}
    loss, _ = loss_fn(CFG, params, b)
    want = got["straight32"][0]["steps"][3]["loss"]
    assert _rel(want, loss.item()) <= 1e-5, (want, loss.item())


def ckpt_batch(step):
    from repro_torch.data.pipeline import make_batch
    return make_batch(DATA, step, 0, 1)


def test_8bit_moments_are_refused_on_another_grid(runs):
    root, _, _, _ = runs
    d = os.path.join(root, "straight8")
    for plan in (grid_plan(1, 1), grid_plan(4, 4)):
        with pytest.raises(ValueError, match=f"2x2 grid.*{plan.grid_q}x"
                                             f"{plan.grid_r} grid"):
            ckpt.restore_grid_state(d, CFG, plan, 0, True)
    with pytest.raises(ValueError, match="local shard"):
        ckpt.restore_train_state(d)
    # the same grid in the same storage reads each PE's own rows
    _, _, opt = ckpt.restore_grid_state(d, CFG, PLAN, 3, True)
    assert opt["m"]["embed"].q.shape[1] == 128
    # JAX's own 8-bit grid file holds PE 0's rows alone for a stacked leaf
    with pytest.raises(ValueError, match="PE 0's 8-bit moments alone"):
        ckpt.restore_grid_state(os.path.join(root, "jax_cannon_8"), CFG,
                                PLAN, 1, True, written=(2, 2, True))


@pytest.mark.parametrize("storage", [True, False, "opt"], ids=str)
def test_4x4_stored_form_matches_jax(tmp_path, plan16, storage):
    jcfg = CFGS["hybrid"]
    cfg = torch_config(jcfg)
    plan = grid_plan(4, 4)
    specs = param_specs(jcfg, 4, 4, preskew=storage)
    stored = jax.tree.map(np.asarray, init_numpy(specs))
    glob = from_jax_params(jax.tree.map(np.asarray, gather_params(
        stored, specs, 4, 4)), cfg, device="cpu")
    blocks = [shard_params(glob, cfg, plan, pe, storage=storage)
              for pe in range(plan.n_pes)]
    want_paths, want = flatten_with_paths(stored)
    got_paths, got = flatten_with_paths(ckpt.assemble_stored(blocks))
    assert got_paths == want_paths
    layouts = {dict(s.meta).get("layout") for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, pm.ParamSpec))}
    assert {"blocked2d", "vocab2d", "expert_flat"} <= layouts
    for p, a, b in zip(want_paths, want, got):
        assert np.array_equal(a, b), p
    # read back: per PE from the stored leaves, and at 1x1 from the meta
    states = []
    for b in blocks:
        o = init_state(b, AdamWConfig())
        for m, t in zip(leaves(o["m"], lambda n: hasattr(n, "dense")),
                        leaves(b)):
            m.dense.copy_(2 * t)
        states.append({"params": b, "opt": o})
    ckpt.save(str(tmp_path), 0, ckpt.assemble_stored(states),
              extra_meta={"grid": [4, 4], "storage": storage,
                          "moments": "local_shards"})
    for pe in (0, 6, 13):
        _, p, o = ckpt.restore_grid_state(str(tmp_path), cfg, plan, pe,
                                          storage)
        assert flatten_with_paths(p)[0] == flatten_with_paths(blocks[pe])[0]
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(p), leaves(blocks[pe])))
        assert all(torch.equal(m.dense, 2 * b) for m, b in zip(
            leaves(o["m"], lambda n: hasattr(n, "dense")), leaves(p)))
    _, p, o = ckpt.restore_train_state(str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(glob)))


def test_a_drill_deciding_otherwise_on_one_pe_raises():
    """PE 1's injector alone fails step 0: it meets the others' first
    step collective at its "transient failure" barrier, and every PE
    raises ``CollectiveMismatch`` naming both, well inside the timeout."""
    t0 = time.perf_counter()
    with pytest.raises(PeFailed) as err:
        run_pes(mismatch_drill, PLAN, args=(1,), device="cpu", timeout=30)
    assert time.perf_counter() - t0 < 25
    text = str(err.value)
    assert "CollectiveMismatch" in text
    assert "step 0: transient failure" in text and "barrier_all" in text


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_launcher_drill_stops_and_resumes(tmp_path, capfd):
    from repro_torch.launch.train import main
    base = ["--arch", "qwen2-0.5b", "--grid", "2x2", "--strategy",
            "cannon", "--device", "cpu", "--steps", "4", "--ckpt-every",
            "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="stopped at step 3"):
        main(base + ["--fail-at-step", "3"])
    drill = _json_lines(capfd.readouterr().out)[-1]
    assert drill["steps"] == [0, 1, 2] and drill["stopped_at"] == 3
    assert drill["retries"] == 3 and drill["ckpt_step"] == 1
    main(base)
    resumed = _json_lines(capfd.readouterr().out)[-1]
    assert resumed["start_step"] == 2 and resumed["steps"] == [2, 3]
    assert resumed["restored"]["step"] == 1
    assert resumed["losses"][0] == drill["losses"][2]
    assert [c["step"] for c in resumed["checkpoints"]] == [3]
    assert resumed["losses_equal_on_every_pe"]
    assert resumed["launches_equal_on_every_pe"]
    assert ckpt.all_steps(str(tmp_path)) == [1, 3]


@pytest.mark.parametrize("flag", ["--service", "--supervised"])
def test_serve_launcher_refuses_the_service_on_a_grid(flag, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as err:
        main(["--arch", "qwen2-0.5b", flag, "--grid", "2x2", "--smoke",
              "--device", "cpu"])
    assert err.value.code != 0
    assert "ROADMAP section 1 item 5" in capsys.readouterr().err
