"""The port's three examples (``repro_torch.examples``), run in-process on
the CPU at small sizes.

* quickstart: both programming models' products within 1e-4 of the
  host's fp64 product (fp32 operands, n = 64), and the analytic Table 1
  rows equal to the JAX package's ``table1_report()``;
* serve_decode: the two fixed-batch modes give the same tokens (one
  function on one card), and the engine's tokens equal a direct
  ``generate`` on an engine built the same way; with ``--config`` the
  reduced mamba2-780m the same;
* train_lm: the loss falls, and a run stopped by its fault drill and
  resumed from its checkpoint gives the uninterrupted run's next losses.

Tiny CPU ops run on one thread here (restored after the module): with
every core's thread pool each op waits on the others.
"""

import pytest
import torch

from repro.core.epiphany_model import table1_report as j_table1_report
from repro_torch.configs import get_config, reduced
from repro_torch.examples import quickstart, serve_decode, train_lm
from repro_torch.runtime.fault_tolerance import TransientWorkerFailure
from repro_torch.serve.engine import SamplingParams, build_engine, generate

SERVE_ARGS = ["--device", "cpu", "--d-model", "64", "--layers", "2",
              "--vocab", "256", "--batch", "2", "--s-max", "64",
              "--tokens", "4", "--requests", "3"]
TRAIN_ARGS = ["--device", "cpu", "--d-model", "64", "--layers", "2",
              "--vocab", "512", "--seq", "32", "--batch", "4",
              "--lr", "3e-3", "--warmup", "2", "--ckpt-every", "3"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    out = quickstart.main(["--device", "cpu", "--n", "64"])
    assert set(out["max_err"]) == {"hybrid", "opencl"}
    assert max(out["max_err"].values()) <= 1e-4
    j_rows, j_meta = j_table1_report()
    assert out["table1"] == j_rows and out["table1_meta"] == j_meta
    assert all(ev.launches == 1 and ev.flops > 0
               for ev in out["events"].values())
    assert "Paper Table 1" in capsys.readouterr().out


def _direct(cfg, params, prompts, s_max):
    eng = build_engine(cfg, engine_cfg=serve_decode.engine_config(s_max,
                                                                  "cpu"),
                       params=params)
    return [c.tokens for c in generate(eng, prompts,
                                       SamplingParams(max_tokens=8))]


def test_serve_decode():
    out = serve_decode.main(SERVE_ARGS)
    fixed = out["fixed"]
    assert fixed["batched"].shape == (2, 5)
    assert (fixed["batched"] == fixed["gemv"]).all()
    got = [c.tokens for c in out["engine"]]
    assert all(len(t) == 8 for t in got)
    assert got == _direct(out["config"], out["params"], out["prompts"], 64)
    assert out["stream"] == got[0][:6]


def test_serve_decode_config():
    out = serve_decode.main(["--device", "cpu", "--config", "mamba2_780m"])
    cfg = reduced(get_config("mamba2-780m"))
    assert out["config"] == cfg
    eng = build_engine(cfg, engine_cfg=serve_decode.engine_config(64, "cpu"),
                       seed=0)
    want = [c.tokens for c in generate(eng, out["prompts"],
                                       SamplingParams(max_tokens=8))]
    assert [c.tokens for c in out["engine"]] == want


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    return train_lm.main(TRAIN_ARGS + [
        "--steps", "6", "--ckpt", str(tmp_path_factory.mktemp("straight"))])


def test_train_lm_loss_falls(straight):
    losses = [loss for _, loss in straight["losses"]]
    assert straight["start"] == 0 and len(losses) == 6
    assert losses[-1] < losses[0]


def test_train_lm_resume_gives_the_straight_run(straight, tmp_path):
    # checkpoint after step 2; step 4 fails past the retry budget
    with pytest.raises(TransientWorkerFailure):
        train_lm.main(TRAIN_ARGS + ["--steps", "6", "--ckpt", str(tmp_path),
                                    "--fail-at-step", "4"])
    resumed = train_lm.main(TRAIN_ARGS + ["--steps", "6", "--ckpt",
                                          str(tmp_path)])
    assert resumed["start"] == 3
    assert [s for s, _ in resumed["losses"]] == [3, 4, 5]
    for (_, got), (_, want) in zip(resumed["losses"],
                                   straight["losses"][3:]):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    for name, p in resumed["params"]["layers"][0]["mixer"].items():
        want = straight["params"]["layers"][0]["mixer"][name]
        assert torch.allclose(p, want, rtol=1e-5, atol=1e-6), name
