"""The training substrates of the port (``repro_torch.optim``, ``ckpt``,
``runtime.fault_tolerance``, ``data``, ``train.step``,
``launch.train``), as ``tests/test_substrates.py`` and
``tests/test_arch_smoke.py`` hold the JAX package's: AdamW on a quadratic,
the schedule's shape, the int8 moment round trip, compression with error
feedback, checkpoint round trip, pruning and atomic commit, the
controller's retry, resume and non-finite skip, data determinism (and the
same batches as the JAX pipeline, bit for bit), slicing the update (the
same bits as one pass), one training step of every non-LATER architecture
reduced, the forward-only kernels' refusal of autograd, and the launcher.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.data.pipeline import DataConfig, batch_iterator, make_batch
from repro_torch.kernels import forbid_grad
from repro_torch.launch import train as launch
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import (AdamWConfig, _dequantize, _quantize,
                                     apply_updates, init_state, lr_schedule)
from repro_torch.optim.compress import (_dequant, _quant,
                                        compressed_allreduce, compressed_psum)
from repro_torch.runtime.fault_tolerance import (FaultConfig, TrainController,
                                                 TransientWorkerFailure)
from repro_torch.train.step import (decay_mask, init_resid, make_train_step,
                                    reduce_grads)
from repro_torch.tree import Pieces, leaves

# ---------------------------------------------------------------------------
# Optimizer and compression.
# ---------------------------------------------------------------------------


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0,
                      warmup_steps=0, decay_steps=10_000)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_state(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state["step"]) == 200


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_schedule(cfg, 0)) == 0.0
    assert abs(float(lr_schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(lr_schedule(cfg, 100)) <= 0.100001 * 1.0 + 1e-6
    mid = [float(lr_schedule(cfg, s)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(mid, mid[1:]))


def test_int8_state_quantization_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32)) * 3.0
    q, s = _quantize(x)
    assert q.dtype == torch.int8 and q.shape == (8, 128)
    y = _dequantize(q, s, x.shape)
    assert float((y - x).abs().max() / x.abs().max()) < 0.02


def test_grad_compression_error_feedback():
    """Compressed psum with error feedback tracks the true sum over
    steps."""
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(512)
                         .astype(np.float32))
    res = torch.zeros_like(g)
    acc_true, acc_comp = torch.zeros_like(g), torch.zeros_like(g)
    for i in range(20):
        gi = g * (1 + 0.1 * i)
        out, res = compressed_psum(gi, res)
        acc_true += gi
        acc_comp += out
    assert float(torch.linalg.norm(acc_comp - acc_true)
                 / torch.linalg.norm(acc_true)) < 0.01


def test_compressed_allreduce_feeds_back_its_error():
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(700)
                         .astype(np.float32))
    summed, res = compressed_allreduce(g, torch.zeros_like(g))
    assert 0 < float((summed - g).abs().max()) < 0.05 * float(g.abs().max())
    assert float(res.abs().max()) > 0
    # the residual is what the wire failed to carry of this worker's
    # gradient: its int8 codes in blocks of 256, dequantized
    q, s, _ = _quant(g)
    assert q.shape == (3, 256)
    assert torch.equal(res, g - _dequant(q, s)[:700])


@pytest.mark.parametrize("bits", [32, 8])
def test_sliced_update_gives_the_same_bits(bits):
    """Slices of 256 elements, per-part Pieces, and one pass over each
    leaf: the same parameters and moments, bit for bit."""
    rng = np.random.default_rng(3)
    shapes = {"stacked": (4, 16, 48), "odd": (3, 37), "vec": (1000,)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, state_bits=bits)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    runs = []
    for max_slice, pieces in ((1 << 25, False), (256, True)):
        p = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        st = init_state(p, cfg)
        r = np.random.default_rng(4)
        for _ in range(3):
            g = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 for k, s in shapes.items()}
            if pieces:
                g = {k: Pieces(v.unbind(0)) if v.ndim > 1 else v
                     for k, v in g.items()}
            p, st, _ = apply_updates(p, g, st, cfg, max_slice=max_slice)
        runs.append((p, st))
    for a, b in zip(leaves(runs[0]), leaves(runs[1])):
        assert torch.equal(a, b)


def test_sliced_compression_gives_the_same_bits():
    rng = np.random.default_rng(5)
    params = {"layers": [{"ffn": {"w_up": torch.zeros(4, 32, 64)}}],
              "embed": torch.zeros(300, 16)}
    g = [rng.standard_normal((4, 32, 64)).astype(np.float32),
         rng.standard_normal((300, 16)).astype(np.float32)]
    out = []
    for as_pieces in (False, True):
        resid = init_resid(params, torch.float32)
        grads = [[torch.from_numpy(x) for x in g[1:]],
                 list(torch.from_numpy(g[0]).unbind(0)) if as_pieces
                 else [torch.from_numpy(g[0])]]
        tree, norm = reduce_grads(params, grads, resid)
        out.append((leaves(tree), leaves(resid), norm))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        a = torch.cat([t.reshape(-1) for t in a]) if isinstance(a, Pieces) \
            else a.reshape(-1)
        b = torch.cat([t.reshape(-1) for t in b]) if isinstance(b, Pieces) \
            else b.reshape(-1)
        assert torch.equal(a, b)
    assert torch.equal(out[0][2], out[1][2])


def test_decay_mask_matches_the_jax_rule():
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    p = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    m = decay_mask(p)
    assert m["embed"] and m["lm_head"] and not m["final_norm"]["scale"]
    attn, mamba = m["layers"][0], m["layers"][1]
    assert attn["mixer"]["wq"] and not attn["norm1"]["scale"]
    assert mamba["mixer"]["conv_w"] and not mamba["mixer"]["A"]
    assert not mamba["mixer"]["dt_bias"] and not mamba["mixer"]["D"]
    moe = next(e for e in m["layers"] if "router" in e.get("ffn", {}))
    assert moe["ffn"]["router"] and moe["ffn"]["w1"]


# ---------------------------------------------------------------------------
# Checkpoint and the controller.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_prune(tmp_path):
    state = {"a": torch.arange(10.0),
             "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)},
             "l": [torch.zeros(2, dtype=torch.int8)]}
    for step in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), step, state, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [30, 40]
    step, restored = ckpt.restore(str(tmp_path), like=state)
    assert step == 40
    assert torch.equal(restored["a"], torch.arange(10.0))
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["l"][0].dtype == torch.int8
    man = json.loads((tmp_path / "step_00000040" / "manifest.json")
                     .read_text())
    assert [e["path"] for e in man["leaves"]] == \
        ["['a']", "['b']/['c']", "['l']/[0]"]
    assert man["leaves"][1]["dtype"] == "bfloat16"


def test_checkpoint_atomic_no_partial(tmp_path):
    """Staging dirs never count as checkpoints."""
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(4)})
    os.makedirs(str(tmp_path / "step_00000002.tmp-zzz"), exist_ok=True)
    assert ckpt.all_steps(str(tmp_path)) == [1]
    assert ckpt.latest_step(str(tmp_path)) == 1


def _toy_step(params, opt, batch):
    return params, opt, {"loss": torch.tensor(1.0) + 0 * batch["x"].sum()}


def test_controller_retry_and_resume(tmp_path):
    fails = {"n": 0}

    def injector(step):
        if step == 3 and fails["n"] < 2:
            fails["n"] += 1
            raise TransientWorkerFailure("simulated preemption")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2, max_retries=3,
                       fail_injector=injector)
    ctrl = TrainController(_toy_step, lambda s: {"x": torch.ones(2)}, fcfg)
    ctrl.run({"w": torch.zeros(1)}, {"m": torch.zeros(1)}, n_steps=6)
    assert fails["n"] == 2 and ctrl.retries == 2
    assert ckpt.latest_step(str(tmp_path)) == 5
    ctrl2 = TrainController(_toy_step, lambda s: {"x": torch.ones(2)}, fcfg)
    start, _, _ = ctrl2.resume_or_init({"w": torch.zeros(1)},
                                       {"m": torch.zeros(1)})
    assert start == 6


def test_controller_stops_past_its_retry_budget(tmp_path):
    def injector(step):
        if step == 2:
            raise TransientWorkerFailure("preempted for good")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=0, max_retries=2,
                       backoff_s=0.0, fail_injector=injector)
    ctrl = TrainController(_toy_step, lambda s: {"x": torch.ones(2)}, fcfg)
    with pytest.raises(TransientWorkerFailure):
        ctrl.run({"w": torch.zeros(1)}, {}, n_steps=4)
    assert ctrl.retries == 2 and [s for s, _ in ctrl.metrics_log] == [0, 1]


def test_controller_skips_nonfinite(tmp_path):
    def bad_step(params, opt, batch):
        return params, opt, {"loss": torch.tensor(float("nan"))}

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=0)
    ctrl = TrainController(bad_step, lambda s: {}, fcfg)
    ctrl.run({"w": torch.zeros(1)}, {}, n_steps=3)
    assert ctrl.skipped == 3 and not ctrl.metrics_log


def test_step_leaves_the_state_untouched_on_a_nonfinite_loss():
    cfg = reduced(get_config("qwen2-0.5b"))
    p = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    p["lm_head"][0, 0] = float("nan")
    opt = init_state(p, AdamWConfig())
    before = [t.clone() for t in leaves(p)]
    b = {k: torch.from_numpy(v)
         for k, v in make_batch(DataConfig(256, 32, 2), 0, 0, 1).items()}
    p, opt, m = make_train_step(cfg)(p, opt, b)
    assert not torch.isfinite(m["loss"])
    assert int(opt["step"]) == 0
    for a, b_ in zip(before, leaves(p)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

def test_data_deterministic_across_hosts():
    dc = DataConfig(vocab_size=512, seq_len=64, global_batch=8)
    a = make_batch(dc, step=7, shard=3, n_shards=4)
    b = make_batch(dc, step=7, shard=3, n_shards=4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = make_batch(dc, step=7, shard=2, n_shards=4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    it = batch_iterator(dc, 3, 4, start_step=7)
    np.testing.assert_array_equal(next(it)["tokens"], a["tokens"])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=64, global_batch=2),
    dict(vocab_size=151936, seq_len=128, global_batch=8, seed=3),
    dict(vocab_size=128, seq_len=48, global_batch=2, patches=16,
         patch_dim=64, frames=4, frame_dim=8)])
def test_batches_equal_the_jax_pipeline(kw):
    for step, shard, n in ((0, 0, 1), (5, 1, 2)):
        want = jax_make_batch(JaxDataConfig(**kw), step, shard, n)
        got = make_batch(DataConfig(**kw), step, shard, n)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(want[k], got[k])


# ---------------------------------------------------------------------------
# Every architecture the port trains, reduced (tests/test_arch_smoke.py).
# ---------------------------------------------------------------------------

def _arch_run(arch, steps, lr, same_batch):
    cfg = reduced(get_config(arch))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1)
    p, opt, step_fn = launch.setup(cfg, device="cpu", opt_cfg=opt_cfg)
    dc = launch.data_config(cfg, 64, 2, full=False)
    before = [t.clone() for t in leaves(p)]
    losses = []
    for s in range(steps):
        p, opt, m = step_fn(p, opt, launch.device_batch(
            dc, 0 if same_batch else s, "cpu"))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    return before, p, losses


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_one_step(arch):
    before, p, losses = _arch_run(arch, 1, 1e-3, False)
    assert np.isfinite(losses[0]) and losses[0] > 0
    after = leaves(p)
    assert max(float((a.float() - b.float()).abs().max())
               for a, b in zip(before, after)) > 0
    for a, b in zip(before, after):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "mamba2-780m"])
def test_arch_two_steps_on_one_batch_lower_the_loss(arch):
    _, _, losses = _arch_run(arch, 2, 5e-3, True)
    assert all(np.isfinite(losses)) and losses[1] < losses[0], losses


# ---------------------------------------------------------------------------
# Forward-only kernels refuse autograd; the launcher.
# ---------------------------------------------------------------------------

def test_forbid_grad_raises_only_when_a_gradient_would_be_lost():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="paged_attention_cuda"):
        forbid_grad("paged_attention_cuda", x, None)
    forbid_grad("op", torch.zeros(2), None)          # nothing requires grad
    with torch.no_grad():
        forbid_grad("op", x)                          # grad mode off


def test_cuda_wrappers_check_autograd_before_the_device():
    """Each forward-only CUDA wrapper refuses an input that requires grad
    before anything else (here on CPU tensors, so the check is what
    raises); under no_grad the same call fails on the device instead."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.grouped_mm.kernel import (grouped_mm_cuda,
                                                       grouped_mm_swiglu_cuda)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda)
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda,
                                                     ssd_scan_fused_cuda)
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    x = torch.zeros(1, 4, 2, 8, requires_grad=True)
    dt, A = torch.zeros(1, 4, 2), torch.zeros(2)
    bc = torch.zeros(1, 4, 1, 8)
    off = torch.zeros(3, dtype=torch.int32)
    calls = {
        "paged_attention_cuda": lambda: paged_attention_cuda(
            q, q, q, off[None], off[None], stride=4),
        "flash_attention_cuda": lambda: flash_attention_cuda(q, q, q),
        "ssd_chunk_cuda": lambda: ssd_chunk_cuda(x, dt, A, bc, bc, chunk=4),
        "ssd_apply_cuda": lambda: ssd_apply_cuda(x[None], bc[None], dt[None],
                                                 bc),
        "ssd_scan_fused_cuda": lambda: ssd_scan_fused_cuda(
            x, dt, A, bc, bc, bc, chunk=4),
        "grouped_mm_cuda": lambda: grouped_mm_cuda(q[0, 0], q[0], off),
        "grouped_mm_swiglu_cuda": lambda: grouped_mm_swiglu_cuda(
            q[0, 0], q[0], off),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call()
        with torch.no_grad(), pytest.raises((ValueError, TypeError)):
            call()


def test_launcher_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "qwen2-0.5b", "--steps", "1"])


def test_launcher_reckons_the_state_and_refuses_what_does_not_fit():
    full = get_config("qwen3-moe-235b-a22b")
    two = launch.train_config("qwen3-moe-235b-a22b", full=True, layers=2)
    b32 = launch.train_state_bytes(two, 32)
    b8 = launch.train_state_bytes(two, 8)
    assert b8["params"] == b32["params"] == b8["grads"]
    assert b8["moments"] < 0.3 * b32["moments"]
    assert 30e9 < b8["total"] < 45e9 < 60e9 < b32["total"]
    with pytest.raises(MemoryError, match="host"):
        launch.check_fit(dataclasses.replace(full, n_layers=94), "cpu", 8)
    with pytest.raises(ValueError):
        launch.train_config("jamba-1.5-large-398b", full=True, layers=3)


def test_launcher_trains_fails_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-moe-235b-a22b", "--device", "cpu", "--steps",
            "6", "--ckpt-every", "3", "--log-every", "1", "--seq-len", "32",
            "--global-batch", "2", "--state-bits", "8"]

    def losses(out):
        return {d["step"]: d["loss"] for d in map(json.loads,
                                                  out.splitlines())
                if "step" in d}

    launch.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    straight = losses(capsys.readouterr().out)
    assert sorted(straight) == list(range(6))
    with pytest.raises(TransientWorkerFailure):
        launch.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                            "--fail-at-step", "4"])
    assert sorted(losses(capsys.readouterr().out)) == [0, 1, 2, 3]
    assert ckpt.all_steps(str(tmp_path / "b")) == [2]
    launch.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    resumed = losses(capsys.readouterr().out)
    assert sorted(resumed) == [3, 4, 5]
    for s in (3, 4, 5):
        assert resumed[s] == straight[s]
