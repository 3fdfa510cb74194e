"""pixtral (the vision-language family) in the port, against the JAX
package.

On ``tests/test_model_equivalence.py``'s vlm config (2 layers, 8 q over 4
kv heads, 16 stub patches in front of 48 text tokens), fp32, one batch of
the deterministic pipeline with patches (token id -1 and label -100 at the
patch positions), the JAX package's weights at 1x1 carried over with
``from_jax_params``:

* the loss (``forward`` with the patch embeddings times ``vis_proj`` added
  at the first positions) against JAX ``make_loss_fn`` on a 1x1 plan and
  against ``repro.models.ref.loss_ref``, and every gradient leaf,
  ``vis_proj`` included, against ``jax.grad`` (with and without remat);
* ``make_prefill`` against ``forward_ref``'s last position;
* the reduced pixtral-12b served by the port's engine on the CPU and by
  the JAX engine on the 4x4 grid from the same weights: identical greedy
  tokens and ``EngineStats`` (the engine serves the text path; ``vis_proj``
  is unused there, as in the JAX engine);
* the pixtral-12b config at full width (hd 160, group 4, 25.6 GB of bf16
  weights), its reduced sibling, and the training checkpoint's
  ``vis_proj`` across both packages.

Tolerances (fp32): losses rel 1e-5, gradients 1e-4 of each leaf's
largest element, logits 1e-5 of the largest against the oracle; tokens
and counters exactly.  Measured: losses equal to the last bit, gradients
within 1.1e-6.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.ckpt import checkpoint as jax_ckpt
from repro.configs import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models import params as pm
from repro.models.ref import forward_ref, gather_params, loss_ref
from repro.models.transformer import param_specs
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_state as jax_init_state
from repro.partition import DATA, MODEL, MeshPlan
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro.train.step import make_loss_fn
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.models.params import (config_param_bytes, from_jax_params,
                                       init_params, param_bytes)
from repro_torch.models.transformer import forward, loss_fn
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.serve.decode import make_prefill
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS, _batch_for
from test_torch_decode_fixed import init_numpy, torch_config

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
REF_TOL = 1e-5
PLAN11 = MeshPlan((DATA, MODEL), (1, 1), 1, 1)
STATS = ("steps", "prefill_launches", "prefill_chunk_launches",
         "decode_launches", "prompt_tokens_ingested", "tokens_generated",
         "peak_blocks_used", "prefix_hits")


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


class Pixtral:
    """The JAX loss at 1x1, its weights and gradients, the batch, and the
    port's copy."""

    def __init__(self, mesh):
        self.cfg = CFGS["vlm"]
        self.tcfg = torch_config(self.cfg)
        self.loss, self.specs, _ = make_loss_fn(
            self.cfg, mesh, PLAN11, extra_batch_keys=("patches",))
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
        grads = jax.grad(lambda ps: self.loss(ps, self.bj)[0])(self.params)
        self.grads = jax.tree.map(np.asarray, gather_params(
            jax.tree.map(np.asarray, grads), self.specs, 1, 1))

    def port_params(self):
        return from_jax_params(self.gp, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def px(mesh11):
    return Pixtral(mesh11)


def test_loss_matches_jax_make_loss_fn_and_loss_ref(px):
    assert (px.b["tokens"][:, :16] == -1).all()
    lj, mj = px.loss(px.params, px.bj)
    lt, mt = loss_fn(px.tcfg, px.port_params(), px.bt)
    assert _rel(lj, lt.item()) <= LOSS_TOL
    assert int(mj["n_tokens"]) == int(mt["n_tokens"])
    want = float(jax.jit(partial(loss_ref, px.cfg))(px.gp, px.bj))
    assert _rel(want, lt.item()) <= LOSS_TOL


@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_jax_grad(px, remat):
    tp = px.port_params()
    flat = leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = loss_fn(px.tcfg, tp, px.bt, remat=remat)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    paths, wl = flatten_with_paths(px.grads)
    assert len(wl) == len(got)
    assert "['vis_proj']" in paths
    for path, a, g in zip(paths, wl, got):
        g = np.zeros_like(a) if g is None else g.numpy()
        if not np.abs(a).max():
            assert not np.abs(g).max(), path
            continue
        assert _rel(a, g) <= GRAD_TOL, (path, _rel(a, g))


def test_make_prefill_matches_forward_ref(px):
    batch = {k: px.b[k] for k in ("tokens", "patches")}
    x, _ = jax.jit(partial(forward_ref, px.cfg))(
        px.gp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray((x[:, -1] @ px.gp["lm_head"]).astype(jnp.float32))
    got = make_prefill(px.tcfg, extra_batch_keys=("patches",))(
        px.port_params(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(want, got[:, 0].numpy()) <= REF_TOL
    with pytest.raises(ValueError, match="patches"):
        forward(px.tcfg, px.port_params(), {"tokens": px.bt["tokens"]})


def test_reduced_pixtral_engine_matches_jax_engine(mesh16, plan16):
    """Four mixed-length text prompts, 6 greedy tokens, buckets (1, 2),
    stride 4, chunks (8,)."""
    jcfg = j_reduced(j_get_config("pixtral-12b"))
    ec = dict(s_max=32, buckets=(1, 2), block_pos_stride=4,
              prefill_chunks=(8,))
    # the engine's weights (natural blocks on the 4x4 grid), drawn with
    # numpy: reduced pixtral stores its 4 kv heads with no replicas
    specs = param_specs(jcfg, 4, 4, preskew=False)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh16, s)),
        init_numpy(specs, seed=0), pm.param_pspecs(specs))
    jeng = j_build_engine(jcfg, mesh16, plan16, params=params,
                          engine_cfg=JEngineConfig(**ec))
    gp = jax.tree.map(np.asarray,
                      gather_params(jeng.params, jeng.specs, 4, 4))
    tcfg = torch_config(jcfg)
    assert tcfg.vis_patches == 16 and "vis_proj" in gp
    teng = build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                        engine_cfg=EngineConfig(device="cpu", **ec))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, jcfg.vocab_size,
                            size=int(rng.integers(2, 20))).tolist()
               for _ in range(4)]
    jo = j_generate(jeng, prompts, JSamplingParams(max_tokens=6))
    to = generate(teng, prompts, SamplingParams(max_tokens=6))
    assert [c.tokens for c in to] == [c.tokens for c in jo]
    assert all(c.finish_reason == "length" for c in to)
    assert {k: getattr(teng.stats, k) for k in STATS} \
        == {k: getattr(jeng.stats, k) for k in STATS}


def test_pixtral_12b_resolves_at_full_width():
    cfg = get_config("pixtral-12b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd(), cfg.d_ff, cfg.vocab_size,
            cfg.vis_patches) == ("vlm", 40, 5120, 32, 8, 160, 14336, 131072,
                                 1024)
    assert cfg.param_dtype == torch.bfloat16
    assert round(config_param_bytes(cfg) / 1e9, 1) == 25.6
    r = reduced(cfg)
    assert r.vis_patches == 16
    p = init_params(r, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert param_bytes(p) == config_param_bytes(r)
    assert p["vis_proj"].shape == (64, 64)


def test_train_checkpoint_carries_vis_proj(tmp_path, px):
    """A port step, a checkpoint, a second step repeated bit for bit from
    it; the JAX package reads the files on a 1x1 plan as the port's
    weights, ``vis_proj`` included."""
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    step_fn = make_train_step(px.tcfg, opt_cfg=opt_cfg, remat=False)
    p = px.port_params()
    o = init_state(p, opt_cfg)
    p, o, _ = step_fn(p, o, px.bt)
    ckpt.save_train_state(str(tmp_path), 1, p, o)
    p1, _, m1 = step_fn(p, o, px.bt)
    want = [t.clone() for t in leaves(p1)]
    _, p2, o2 = ckpt.restore_train_state(str(tmp_path))
    p2, _, m2 = step_fn(p2, o2, px.bt)
    assert m1["loss"].item() == m2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(want, leaves(p2)))
    like_p = init_numpy(px.specs, seed=1)
    _, jstate = jax_ckpt.restore(str(tmp_path), like={
        "params": like_p, "opt": jax_init_state(like_p, JaxAdamW())})
    glob = gather_params(jax.tree.map(np.asarray, jstate["params"]),
                         px.specs, 1, 1)
    paths, port = flatten_with_paths(ckpt.restore_train_state(
        str(tmp_path))[1])
    assert "['vis_proj']" in paths
    for a, b in zip(jax.tree.leaves(glob), port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
