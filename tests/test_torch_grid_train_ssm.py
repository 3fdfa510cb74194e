"""The training step on a 2x2 grid of PE processes against the JAX
package's at 2x2, for the sequence-sharded mamba block, the grid MoE
block and the step's options; the launcher on the grid; and a collective
mismatch across PEs.

As ``tests/test_torch_grid_train.py`` (its helpers, weights and batches),
one spawn of four CPU PE processes for the JAX-parity cases: the ssm
config of ``tests/test_model_equivalence.py`` under cannon (row 0's conv
halo and the cross-row state relay now reach the graph on every row: the
halo is masked by a product, the relay composes the same q-1 prefixes on
every row and picks its own by a one-hot product, as the JAX block does),
the moe config under cannon_opt (the flat exchanges' backward is the
exchange back), the hybrid config under cannon, and the dense config
under cannon with ``grad_compress`` and with two microbatches.

Tolerances, the 1x1 file's: the loss rel 1e-5, ``grad_norm`` rel 1e-4
(JAX's: q*r times the model's), lr rel 1e-6, every PE's parameter blocks
after step 3 within 2e-5 of JAX's cut by ``shard_params``; with
``grad_compress`` within lr (an fp32 difference can flip one int8
rounding of a gradient, as at 1x1).  Every step's heap bytes are the
count ``train_messages`` reckons.

``launch/train.py --grid 2x2 --strategy cannon_opt --device cpu`` trains
the reduced qwen2-0.5b two steps: every PE the same losses, the heap
bytes as reckoned; with ``--ckpt-every 1`` it writes the grid's stored
form, which the 1x1 port reads.  A grid whose PE 1 sums over its row
while the others sum over their columns must raise, naming both
collectives, well inside
the grid's timeout (``runtime/pe.py::HostBarrier``'s tags), not hang.
"""

import json
import time

import numpy as np
import pytest

from repro_torch.launch.grid_run import TrainJob, run_on_grid
from repro_torch.runtime.pe import PeFailed, mismatch_on, run_pes

from test_torch_decode_fixed import torch_config
from test_torch_grid_train import (CONFIGS, OPT, PLAN, _rel, batches,
                                   case_id, jax_train, want_blocks)

CASES = [("ssm", "cannon", {}), ("moe", "cannon_opt", {}),
         ("hybrid", "cannon", {}),
         ("dense", "cannon", {"grad_compress": True}),
         ("dense", "cannon", {"microbatches": 2})]


@pytest.fixture(scope="module")
def runs():
    want, jobs = {}, []
    for case in CASES:
        name, strategy, kw = case
        jcfg = CONFIGS[name]
        want[case_id(case)] = jax_train(jcfg, strategy, **kw)
        jobs.append(TrainJob(torch_config(jcfg), strategy, batches(),
                             weights=want[case_id(case)]["start"], opt=OPT,
                             return_params=True, **kw))
    got = run_on_grid(jobs, PLAN, device="cpu", timeout=120)
    return want, dict(zip(map(case_id, CASES), got))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_steps_match_jax(runs, case):
    want, got = runs
    w = want[case_id(case)]
    for r in got[case_id(case)]:
        for s, (mw, mt) in enumerate(zip(w["metrics"], r["steps"])):
            assert _rel(mw["loss"], mt["loss"]) <= 1e-5, (r["pe"], s)
            assert _rel(mw["ce_loss"], mt["ce_loss"]) <= 1e-5, (r["pe"], s)
            assert _rel(mw["grad_norm"], mt["grad_norm"]) <= 1e-4, \
                (r["pe"], s, mw["grad_norm"], mt["grad_norm"])
            assert _rel(mw["lr"], mt["lr"]) <= 1e-6, (r["pe"], s)
            assert mt["heap_bytes"] == r["reckoned_heap_bytes"], (r["pe"], s)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_param_blocks_match_jax(runs, case):
    want, got = runs
    name, strategy, kw = case
    tol = OPT["lr"] if kw.get("grad_compress") else 2e-5
    for r in got[case_id(case)]:
        blocks = want_blocks(CONFIGS[name], strategy,
                             want[case_id(case)]["end"], r["pe"])
        diffs = {p: float(np.abs(blocks[p] - r["params"][p]).max())
                 for p in blocks}
        assert max(diffs.values()) <= tol, (r["pe"], diffs)


def test_launcher_on_the_grid(capfd, tmp_path):
    from repro_torch.launch.train import main
    # a fresh --ckpt-dir: the launcher resumes from the latest checkpoint
    # of its directory, and the default one may hold another run's
    main(["--arch", "qwen2-0.5b", "--grid", "2x2", "--strategy",
          "cannon_opt", "--device", "cpu", "--steps", "2", "--log-every",
          "1", "--ckpt-dir", str(tmp_path)])
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith("{")]
    done = lines[-1]
    assert done["done"] == 2 and done["losses_equal_on_every_pe"]
    assert done["heap_bytes_per_pe"] == [done["reckoned_heap_bytes"]]
    assert all(np.isfinite(done["losses"]))
    assert [x["step"] for x in lines if "step" in x] == [0, 1]


def test_launcher_checkpoints_on_a_grid(capfd, tmp_path):
    """``--ckpt-every`` on a grid writes the grid's stored form, marked
    in its meta, which the 1x1 port reads."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.train import main
    main(["--arch", "qwen2-0.5b", "--grid", "2x2", "--device", "cpu",
          "--steps", "2", "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    done = [json.loads(x) for x in capfd.readouterr().out.splitlines()
            if x.startswith("{")][-1]
    assert [c["step"] for c in done["checkpoints"]] == [0, 1]
    assert ckpt.all_steps(str(tmp_path)) == [0, 1]
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        meta = json.load(f)["meta"]
    assert meta == {"grid": [2, 2], "storage": "opt",
                    "moments": "local_shards"}
    step, params, opt = ckpt.restore_train_state(str(tmp_path))
    assert step == 1 and int(opt["step"]) == 2
    assert params["embed"].shape[0] % 4 == 0


def test_collective_mismatch_raises_naming_both():
    t0 = time.perf_counter()
    with pytest.raises(PeFailed) as err:
        run_pes(mismatch_on, PLAN, args=(1,), device="cpu", timeout=30)
    assert time.perf_counter() - t0 < 25
    text = str(err.value)
    assert "CollectiveMismatch" in text
    assert "psum_cols" in text and "psum_rows" in text
