"""Three AdamW training steps of the port against ``make_train_step`` of
the JAX package on a 1x1 plan, on the same batches and weights (fp32), for
the five decoder configs of ``tests/test_model_equivalence.py``; the
step's options are held in ``tests/test_torch_train_options.py``.

Held after every step: the loss, ``grad_norm`` and ``lr`` the step
reports, and after the third step every parameter.  The steps run at
lr 1e-3 with eps 1e-6: in its first steps Adam moves an element by about
``lr * sign(g)`` whatever the size of g, so at eps 1e-8 an element whose
gradient is fp32 noise in both packages moves by +-lr at random; eps 1e-6
keeps such elements still in both, and every other element is held
tightly.

Tolerances: the loss rel 1e-5, ``grad_norm`` rel 1e-4, ``lr`` rel 1e-6;
the parameters within 2e-5 absolute (2 % of one step's lr; measured at
most 8.2e-6) with fp32 moments, also with two microbatches.  With
``grad_compress`` an fp32 difference can flip one int8 rounding of the
gradient (a step of max|g| / 127 of its 256-block), so the parameters are
held within lr (1e-3; measured 4.3e-4).  With 8-bit moments the same
kind of flip moves one moment code by one step: the codes are held within
one quantization step, the losses and norms as above, the parameters
within 10 lr (measured 6.4e-3, a code of a second moment near zero).  The
optimizer alone, fed the same gradients, gives identical 8-bit codes over
three steps, and the parameters within 1e-4 (the fp32 moments within
1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.data.pipeline import DataConfig, make_batch
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_state as jax_init_state
from repro.partition import DATA, MODEL, MeshPlan
from repro.train.step import make_train_step as jax_train_step
from repro_torch.models.params import from_jax_params
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import init_resid, make_train_step
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS
from test_torch_train import torch_config

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10, eps=1e-6)
STEPS = 3


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(a), 1e-30)


def _run(mesh, family, bits=32, microbatches=1, compress=False):
    cfg = CFGS[family]
    plan = MeshPlan((DATA, MODEL), (1, 1), 1, 1)
    kw = dict(OPT, state_bits=bits)
    step_j, specs, _ = jax_train_step(
        cfg, mesh, plan, opt_cfg=JaxAdamW(**kw), remat=False,
        microbatches=microbatches, grad_compress=compress, donate=False)
    host = pm.init_params(specs, seed=0)
    pj = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                      host, pm.param_pspecs(specs))
    oj = jax_init_state(pj, JaxAdamW(**kw))
    tcfg = torch_config(cfg)
    pt = from_jax_params(jax.tree.map(np.asarray,
                                      gather_params(host, specs, 1, 1)),
                         tcfg, device="cpu")
    ot = init_state(pt, AdamWConfig(**kw))
    if compress:
        oj["resid"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                   pj)
        ot["resid"] = init_resid(pt, torch.float32)
    step_t = make_train_step(tcfg, opt_cfg=AdamWConfig(**kw),
                             microbatches=microbatches,
                             grad_compress=compress)
    for s in range(STEPS):
        b = make_batch(DataConfig(128, 64, 2), s, 0, 1)
        pj, oj, mj = step_j(pj, oj, {k: jnp.asarray(v) for k, v in b.items()})
        pt, ot, mt = step_t(pt, ot, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert _rel(mj["loss"], mt["loss"]) <= 1e-5, (s, "loss")
        assert _rel(mj["ce_loss"], mt["ce_loss"]) <= 1e-5, (s, "ce_loss")
        assert _rel(mj["grad_norm"], mt["grad_norm"]) <= 1e-4, (s, "norm")
        assert _rel(mj["lr"], mt["lr"]) <= 1e-6, (s, "lr")
    want = gather_params(jax.tree.map(np.asarray, pj), specs, 1, 1)
    paths, wl = flatten_with_paths(want)
    diffs = {p: float(np.abs(np.asarray(w, np.float64)
                              - t.double().numpy()).max())
             for p, w, t in zip(paths, wl, leaves(pt))}
    return diffs, oj, ot


@pytest.mark.parametrize("family", ["dense", "dense-kvrep", "moe", "ssm",
                                    "hybrid"])
def test_three_steps_match_jax(mesh11, family):
    diffs, _, _ = _run(mesh11, family)
    assert max(diffs.values()) <= 2e-5, diffs
