"""The port's training forward and gradient against the JAX package.

The five decoder configs of ``tests/test_model_equivalence.py`` (dense
with qk-norm and QKV bias, dense with replicated kv heads, MoE, SSM,
hybrid attention/mamba/MoE), fp32, one batch of the deterministic
pipeline, the same weights (drawn by the JAX package, carried over with
``from_jax_params``).  The JAX side runs on a 1x1 plan
(``MeshPlan((data, model), (1, 1), 1, 1)``), where its grid collectives
are the identity.  MoE parity pins ``capacity_factor`` 16, as
``models/ref.py`` does.

Tolerances (fp32): the loss within rel 1e-5 of JAX's ``make_loss_fn`` and
of ``repro.models.ref.loss_ref`` (measured: 1e-7 and below); every
gradient leaf within 1e-4 of its largest element (measured: at most 1e-5,
the chunked SSD scan's leaves, whose state passing runs as a sequential
loop where JAX runs an associative scan).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.data.pipeline import DataConfig, make_batch
from repro.models import params as pm
from repro.models.ref import gather_params, loss_ref
from repro.models.transformer import param_specs
from repro.partition import DATA, MODEL, MeshPlan
from repro.train.step import make_loss_fn
from repro_torch.models.config import ModelConfig as TorchConfig
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import loss_fn
from repro_torch.train.step import make_loss_fn as port_make_loss_fn
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS

FAMILIES = ["dense", "dense-kvrep", "moe", "ssm", "hybrid"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def torch_config(jcfg) -> TorchConfig:
    names = {f.name for f in dataclasses.fields(TorchConfig)} \
        - {"param_dtype", "compute_dtype"}
    return TorchConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32,
                       compute_dtype=torch.float32)


def batch_np(step=0, vocab=128, seq=64, gb=2):
    return make_batch(DataConfig(vocab, seq, gb), step, 0, 1)


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


PLAN11 = MeshPlan((DATA, MODEL), (1, 1), 1, 1)


class Case:
    """One family's JAX loss at 1x1, its weights, and the port's copy."""

    def __init__(self, family, mesh):
        self.cfg = CFGS[family]
        self.tcfg = torch_config(self.cfg)
        self.loss, self.specs, _ = make_loss_fn(self.cfg, mesh, PLAN11)
        host = pm.init_params(self.specs, seed=0)
        self.params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), host,
            pm.param_pspecs(self.specs))
        self.gp = jax.tree.map(np.asarray,
                               gather_params(host, self.specs, 1, 1))
        self.b = batch_np()
        self.bj = {k: jnp.asarray(v) for k, v in self.b.items()}
        self.bt = {k: torch.from_numpy(v) for k, v in self.b.items()}

    def port_params(self):
        return from_jax_params(self.gp, self.tcfg, device="cpu")


@pytest.fixture(scope="module")
def cases(mesh11):
    return {f: Case(f, mesh11) for f in FAMILIES}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_matches_jax_make_loss_fn(cases, family):
    c = cases[family]
    lj, mj = c.loss(c.params, c.bj)
    lt, mt = port_make_loss_fn(c.tcfg)(c.port_params(), c.bt)
    assert _rel(lj, lt.item()) <= LOSS_TOL
    assert _rel(mj["ce_loss"], mt["ce_loss"].item()) <= LOSS_TOL
    assert abs(float(mj["aux"]) - mt["aux"].item()) <= LOSS_TOL
    assert int(mj["n_tokens"]) == int(mt["n_tokens"])
    if c.cfg.n_experts:
        assert mt["aux"].item() > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_matches_loss_ref_on_grid_weights(family):
    """``loss_ref`` reads weights in a 4x4 grid's stored geometry (q heads
    padded to a multiple of 4, kv heads replicated to 4): the port runs
    that geometry as stored and gives the oracle's loss."""
    cfg = CFGS[family]
    specs = param_specs(cfg, 4, 4)
    gp = jax.tree.map(np.asarray,
                      gather_params(pm.init_params(specs, seed=0), specs,
                                    4, 4))
    b = batch_np(step=1)
    want = float(loss_ref(cfg, gp, {k: jnp.asarray(v) for k, v in b.items()}))
    got, _ = loss_fn(torch_config(cfg),
                     from_jax_params(gp, torch_config(cfg), device="cpu"),
                     {k: torch.from_numpy(v) for k, v in b.items()})
    assert _rel(want, got.item()) <= LOSS_TOL


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("remat", [False, True])
def test_every_gradient_leaf_matches_jax_grad(cases, family, remat):
    c = cases[family]
    gj = jax.grad(lambda ps: c.loss(ps, c.bj)[0])(c.params)
    want = jax.tree.map(np.asarray, gather_params(
        jax.tree.map(np.asarray, gj), c.specs, 1, 1))
    tp = c.port_params()
    flat = leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = loss_fn(c.tcfg, tp, c.bt, remat=remat)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    paths, wl = flatten_with_paths(want)
    assert len(wl) == len(got)
    for path, w, g in zip(paths, wl, got):
        g = np.zeros_like(w) if g is None else g.numpy()
        if not np.abs(w).max():
            assert not np.abs(g).max(), path
            continue
        assert _rel(w, g) <= GRAD_TOL, (path, _rel(w, g))


def test_encdec_and_vision_forward_raise_naming_the_slice():
    """The encoder-decoder and vision-language forwards are ported (their
    parity: tests/test_torch_encdec.py, tests/test_torch_vlm.py); a batch
    without the input their slice added raises naming it."""
    for family, key in (("encdec", "frames"), ("vlm", "patches")):
        with pytest.raises(ValueError, match=key):
            loss_fn(torch_config(CFGS[family]), {}, {})
