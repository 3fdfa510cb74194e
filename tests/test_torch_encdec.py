"""whisper (the encoder-decoder family) in the port, against the JAX package.

On ``tests/test_model_equivalence.py``'s encdec config (2 encoder and 2
decoder layers, layernorm, gelu MLP with biases, 32 stub frames), fp32,
one batch of the deterministic pipeline with frames, the JAX package's
weights at 1x1 carried over with ``from_jax_params``:

* the loss (``forward`` with the encoder, cross attention in every decoder
  layer) against JAX ``make_loss_fn`` on a 1x1 plan and against
  ``repro.models.ref.loss_ref``, and every gradient leaf, encoder and
  cross weights included, against ``jax.grad`` (with and without remat);
* ``make_prefill`` against ``forward_ref``'s last position;
* the fixed-batch decode path with the cross cache filled from the
  encoder (``fill_cross_cache``): teacher-forced, each step's logits
  equal ``forward_ref``'s at that position, in every mode (the JAX
  package's own test holds only the finiteness of a zero cross cache);
  and step by step against JAX ``make_decode_step`` (batched) whose cross
  cache holds the same encoder K/V;
* the whisper-base config and its reduced sibling, the engine's and the
  launcher's refusals (as the JAX package refuses), and the training
  checkpoint's encoder leaves across both packages.

Tolerances (fp32): losses rel 1e-5, gradients 1e-4 of each leaf's
largest element (the test_torch_train bars), logits 1e-5 of the largest
against the JAX step and against the oracle (test_torch_decode_fixed's
bars).  Measured: losses equal to the last bit, gradients within 1.2e-6,
teacher-forced logits within 4.5e-7.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.ckpt import checkpoint as jax_ckpt
from repro.models import params as pm
from repro.models.ref import forward_ref, gather_params, loss_ref
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_state as jax_init_state
from repro.partition import DATA, MODEL, MeshPlan
from repro.serve.decode import cache_pspecs
from repro.serve.decode import cache_specs as j_cache_specs
from repro.serve.decode import make_decode_step as j_make_decode_step
from repro.train.step import make_loss_fn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models.params import (config_param_bytes, from_jax_params,
                                       init_params, param_bytes)
from repro_torch.models.transformer import forward, loss_fn
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.serve.decode import (DECODE_MODES, cache_specs,
                                      fill_cross_cache, make_decode_step,
                                      make_prefill)
from repro_torch.serve.engine import EngineConfig, ServingEngine
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS, _batch_for
from test_torch_decode_fixed import init_numpy, torch_config

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
JAX_TOL = 1e-5
REF_TOL = 1e-5
B, S_MAX, STEPS = 2, 32, 8
PLAN11 = MeshPlan((DATA, MODEL), (1, 1), 1, 1)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


class Whisper:
    """The JAX loss at 1x1, its weights, the batch, and the port's copy."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.cfg = CFGS["encdec"]
        self.tcfg = torch_config(self.cfg)
        self.loss, self.specs, _ = make_loss_fn(self.cfg, mesh, PLAN11,
                                                extra_batch_keys=("frames",))
        host = init_numpy(self.specs, seed=0)
        self.params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), host,
            pm.param_pspecs(self.specs))
        self.gp = jax.tree.map(np.asarray,
                               gather_params(host, self.specs, 1, 1))
        batch, _ = _batch_for(self.cfg)
        self.b = {k: np.array(v) for k, v in batch.items()}
        self.bj = {k: jnp.asarray(v) for k, v in self.b.items()}
        self.bt = {k: torch.from_numpy(v) for k, v in self.b.items()}
        self.toks = self.b["tokens"][:B, :STEPS]
        self.frames = self.b["frames"][:B]

    def port_params(self):
        return from_jax_params(self.gp, self.tcfg, device="cpu")

    def jax_grads(self):
        """Every gradient leaf of the JAX loss, global layout (once)."""
        if not hasattr(self, "_grads"):
            gj = jax.grad(lambda ps: self.loss(ps, self.bj)[0])(self.params)
            self._grads = jax.tree.map(np.asarray, gather_params(
                jax.tree.map(np.asarray, gj), self.specs, 1, 1))
        return self._grads

    def ref_logits(self):
        if not hasattr(self, "_ref"):
            x, _ = jax.jit(partial(forward_ref, self.cfg))(
                self.gp, {"tokens": jnp.asarray(self.toks),
                          "frames": jnp.asarray(self.frames)})
            self._ref = np.asarray((x @ self.gp["lm_head"]).astype(
                jnp.float32))
        return self._ref


@pytest.fixture(scope="module")
def w(mesh11):
    return Whisper(mesh11)


def test_loss_matches_jax_make_loss_fn_and_loss_ref(w):
    lj, mj = w.loss(w.params, w.bj)
    lt, mt = loss_fn(w.tcfg, w.port_params(), w.bt)
    assert _rel(lj, lt.item()) <= LOSS_TOL
    assert _rel(mj["ce_loss"], mt["ce_loss"].item()) <= LOSS_TOL
    assert int(mj["n_tokens"]) == int(mt["n_tokens"])
    want = float(jax.jit(partial(loss_ref, w.cfg))(w.gp, w.bj))
    assert _rel(want, lt.item()) <= LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_jax_grad(w, remat):
    want = w.jax_grads()
    tp = w.port_params()
    flat = leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = loss_fn(w.tcfg, tp, w.bt, remat=remat)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    paths, wl = flatten_with_paths(want)
    assert len(wl) == len(got)
    assert any("enc_layers" in p for p in paths) and \
        any("cross" in p for p in paths)
    for path, a, g in zip(paths, wl, got):
        g = np.zeros_like(a) if g is None else g.numpy()
        if not np.abs(a).max():
            assert not np.abs(g).max(), path
            continue
        assert _rel(a, g) <= GRAD_TOL, (path, _rel(a, g))


def test_forward_needs_the_frames(w):
    with pytest.raises(ValueError, match="frames"):
        forward(w.tcfg, w.port_params(), {"tokens": w.bt["tokens"]})


def test_make_prefill_matches_forward_ref(w):
    want = w.ref_logits()[:, -1]
    prefill = make_prefill(w.tcfg, extra_batch_keys=("frames",))
    got = prefill(w.port_params(), {"tokens": torch.from_numpy(w.toks),
                                    "frames": torch.from_numpy(w.frames)})
    assert got.shape == (B, 1, want.shape[-1])
    assert _rel(want, got[:, 0].numpy()) <= REF_TOL
    with pytest.raises(ValueError, match="frames"):
        make_prefill(w.tcfg)(w.port_params(),
                             {"tokens": torch.from_numpy(w.toks)})


def _port_decode(w, mode):
    params = w.port_params()
    cache = cache_specs(w.tcfg, B, S_MAX, mode, device="cpu")
    fill_cross_cache(w.tcfg, params, cache, torch.from_numpy(w.frames))
    step = make_decode_step(w.tcfg, batch=B, s_max=S_MAX, mode=mode)
    rows = [step(params, cache, torch.from_numpy(w.toks[:, t]), t)
            for t in range(STEPS)]
    return torch.cat(rows, 1).numpy(), cache


@pytest.mark.parametrize("mode", list(DECODE_MODES))
def test_teacher_forced_decode_with_cross_cache_matches_forward_ref(w, mode):
    got, cache = _port_decode(w, mode)
    assert all(float(e["cross_k"].abs().max()) > 0 for e in cache)
    assert _rel(w.ref_logits(), got) <= REF_TOL, _rel(w.ref_logits(), got)


def test_cross_decode_matches_jax_make_decode_step(w):
    """The JAX batched step on a 1x1 plan, its cross cache loaded with the
    encoder K/V the port filled: the same logits and K/V rows, step by
    step."""
    got, tcache = _port_decode(w, "batched")
    step, _, pctx = j_make_decode_step(w.cfg, w.mesh, PLAN11, batch=B,
                                       s_max=S_MAX, mode="batched")
    shapes = j_cache_specs(w.cfg, PLAN11, B, S_MAX, "batched")
    host = [{k: (t.numpy()[:, None] if k.startswith("cross") else
                 np.zeros(shapes[i][k].shape, np.float32))
             for k, t in e.items()} for i, e in enumerate(tcache)]
    cache = jax.tree.map(
        lambda a, sp: jax.device_put(jnp.asarray(a),
                                     NamedSharding(w.mesh, sp)),
        host, cache_pspecs(w.cfg, "batched", pctx.data_axes))
    want = []
    for t in range(STEPS):
        tok = jax.device_put(jnp.asarray(w.toks[:, t]),
                             NamedSharding(w.mesh, P(DATA)))
        logits, cache = step(w.params, cache, tok, jnp.int32(t))
        want.append(np.asarray(logits))
    assert _rel(np.concatenate(want, 1), got) <= JAX_TOL
    for je, te in zip(jax.tree.map(np.asarray, cache), tcache):
        assert _rel(je["k"][:, 0], te["k"].numpy()) <= JAX_TOL


def test_whisper_base_resolves_and_reduces():
    cfg = get_config("whisper-base")
    assert (cfg.family, cfg.n_layers, cfg.enc_layers, cfg.enc_seq,
            cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) == (
        "encdec", 6, 6, 1500, 512, 8, 2048, 51865)
    assert (cfg.norm, cfg.act, cfg.mlp_bias, cfg.qkv_bias) == (
        "layernorm", "gelu", True, True)
    r = reduced(cfg)
    assert (r.enc_layers, r.n_layers, r.enc_seq) == (2, 2, 32)
    p = init_params(r, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert param_bytes(p) == config_param_bytes(r)
    assert p["enc_pos"].shape == (32, 64) and len(p["enc_layers"]) == 1
    assert set(p["layers"][0]) >= {"cross", "norm_cross"}
    assert round(config_param_bytes(cfg) / 1e6) == 196


def test_engine_and_launcher_refuse_whisper():
    cfg = reduced(get_config("whisper-base"))
    with pytest.raises(NotImplementedError, match="fixed-batch"):
        ServingEngine(cfg, engine_cfg=EngineConfig(
            s_max=32, buckets=(1,), block_pos_stride=4, device="cpu"))
    with pytest.raises(SystemExit, match="encoder pass"):
        launch_serve.main(["--arch", "whisper-base", "--smoke",
                           "--device", "cpu"])


def test_train_checkpoint_carries_the_encoder_leaves(tmp_path, w, mesh11):
    """A port step, a checkpoint, a second step: restored, the second
    step repeats bit for bit, and the JAX package reads the same files on
    a 1x1 plan as the port's weights, encoder and cross leaves
    included."""
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    step_fn = make_train_step(w.tcfg, opt_cfg=opt_cfg, remat=False)
    p = w.port_params()
    o = init_state(p, opt_cfg)
    p, o, _ = step_fn(p, o, w.bt)
    ckpt.save_train_state(str(tmp_path), 1, p, o)
    p1, _, m1 = step_fn(p, o, w.bt)
    want = [t.clone() for t in leaves(p1)]
    step, p2, o2 = ckpt.restore_train_state(str(tmp_path))
    assert step == 1
    p2, _, m2 = step_fn(p2, o2, w.bt)
    assert m1["loss"].item() == m2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(want, leaves(p2)))
    like_p = init_numpy(w.specs, seed=1)
    like_o = jax_init_state(like_p, JaxAdamW())
    _, jstate = jax_ckpt.restore(str(tmp_path),
                                 like={"params": like_p, "opt": like_o})
    glob = gather_params(jax.tree.map(np.asarray, jstate["params"]),
                         w.specs, 1, 1)
    paths, port = flatten_with_paths(ckpt.restore_train_state(
        str(tmp_path))[1])
    assert any("enc_layers" in p for p in paths)
    for a, b in zip(jax.tree.leaves(glob), port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
