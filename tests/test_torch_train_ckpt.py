"""Training checkpoints across the two packages (the JAX on-disk format).

* A JAX training checkpoint written on the 16-PE grid (4 x 4) after one
  step, parameters and fp32 moments, is read into the port's global
  layout (``restore_train_state``): the port's loss on it equals the JAX
  loss on the same state (rel 1e-5), the moments equal the JAX moments
  gathered to the global layout, and the step is carried.  Two storage
  modes: ``cannon`` (every block pre-skewed; the dense config with kv
  heads replicated over the grid's columns) and ``cannon_opt`` (the
  output projections stored C-rotating; the hybrid config with mamba and
  MoE layers).  Its 8-bit moments, quantized per local shard, are
  refused.
* A port checkpoint is restored by the port and gives the same next step,
  bit for bit; the JAX package restores the same files on a 1x1 plan and
  gets the port's parameters and the port's loss.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.ckpt import checkpoint as jax_ckpt
from repro.data.pipeline import DataConfig, make_batch
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.models.transformer import param_specs
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import init_state as jax_init_state
from repro.partition import DATA, MODEL, MeshPlan
from repro.train.step import make_loss_fn, make_train_step as jax_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_paths, leaves

from test_model_equivalence import CFGS
from test_torch_train import torch_config


def _batch(step):
    return make_batch(DataConfig(128, 64, 2), step, 0, 1)


def _jax_state(cfg, mesh, plan, strategy, bits=32):
    """One JAX training step on the grid: (params, opt, specs)."""
    opt_cfg = JaxAdamW(lr=1e-3, warmup_steps=1, state_bits=bits)
    step, specs, _ = jax_step(cfg, mesh, plan, opt_cfg=opt_cfg,
                              tp_strategy=strategy, remat=False,
                              donate=False)
    params = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        pm.init_params(specs, seed=0), pm.param_pspecs(specs))
    opt = jax_init_state(params, opt_cfg)
    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(DATA)))
         for k, v in _batch(0).items()}
    params, opt, _ = step(params, opt, b)
    return params, opt, specs


@pytest.mark.parametrize("family,strategy,storage", [
    ("dense-kvrep", "cannon", True), ("hybrid", "cannon_opt", "opt")])
def test_jax_16pe_checkpoint_restores_into_the_port(tmp_path, mesh16, plan16,
                                                    family, strategy,
                                                    storage):
    cfg = CFGS[family]
    params, opt, specs = _jax_state(cfg, mesh16, plan16, strategy)
    jax_ckpt.save(str(tmp_path), 0, {"params": params, "opt": opt})
    step, tp, to = ckpt.restore_train_state(str(tmp_path), q=4, r=4,
                                            storage=storage)
    assert step == 0 and int(to["step"]) == 1
    b = _batch(1)
    lf, _, _ = make_loss_fn(cfg, mesh16, plan16, tp_strategy=strategy)
    want, _ = lf(params, {k: jax.device_put(jnp.asarray(v),
                                            NamedSharding(mesh16, P(DATA)))
                          for k, v in b.items()})
    got, _ = loss_fn(torch_config(cfg), tp,
                     {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(want) - got.item()) <= 1e-5 * abs(float(want))
    # the first moments, gathered to the global layout
    m_dense = jax.tree.map(lambda ms: np.asarray(ms.dense), opt["m"],
                           is_leaf=lambda x: hasattr(x, "dense"))
    want_m = gather_params(m_dense, specs, 4, 4)
    got_m = [ms.dense for ms in leaves(to["m"],
                                       lambda n: hasattr(n, "_fields"))]
    for a, b_ in zip(jax.tree.leaves(want_m), got_m):
        np.testing.assert_array_equal(np.asarray(a), b_.numpy())


def test_jax_16pe_8bit_moments_are_refused(tmp_path, mesh16, plan16):
    params, opt, _ = _jax_state(CFGS["dense"], mesh16, plan16, "cannon",
                                bits=8)
    jax_ckpt.save(str(tmp_path), 0, {"params": params, "opt": opt})
    with pytest.raises(ValueError, match="local shard"):
        ckpt.restore_train_state(str(tmp_path), q=4, r=4)


@pytest.mark.parametrize("bits", [32, 8])
def test_port_checkpoint_resumes_the_same_next_step(tmp_path, bits):
    cfg = torch_config(CFGS["hybrid"])
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, state_bits=bits)
    step_fn = make_train_step(cfg, opt_cfg=opt_cfg)
    gp = jax.tree.map(np.asarray, gather_params(
        *_port_init(CFGS["hybrid"])))
    p = from_jax_params(gp, cfg, device="cpu")
    o = init_state(p, opt_cfg)
    bt = [{k: torch.from_numpy(v) for k, v in _batch(s).items()}
          for s in range(3)]
    for s in range(2):
        p, o, _ = step_fn(p, o, bt[s])
    ckpt.save_train_state(str(tmp_path), 1, p, o)
    p1, o1, m1 = step_fn(p, o, bt[2])
    want = [t.clone() for t in leaves(p1)]
    step, p2, o2 = ckpt.restore_train_state(str(tmp_path))
    assert step == 1 and int(o2["step"]) == 2
    p2, o2, m2 = step_fn(p2, o2, bt[2])
    assert m1["loss"].item() == m2["loss"].item()
    for a, b_ in zip(want, leaves(p2)):
        assert torch.equal(a, b_)

    # the JAX package reads the same files on a 1x1 plan
    mesh = jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    plan = MeshPlan((DATA, MODEL), (1, 1), 1, 1)
    lf, specs, _ = make_loss_fn(CFGS["hybrid"], mesh, plan)
    like_p = pm.init_params(specs, seed=1)
    like_o = jax_init_state(like_p, JaxAdamW(state_bits=bits))
    jstep, jstate = jax_ckpt.restore(str(tmp_path),
                                     like={"params": like_p, "opt": like_o})
    assert jstep == 1 and int(jstate["opt"]["step"]) == 2
    glob = gather_params(jax.tree.map(np.asarray, jstate["params"]), specs,
                         1, 1)
    _, port_before = flatten_with_paths(
        ckpt.restore_train_state(str(tmp_path))[1])
    for a, b_ in zip(jax.tree.leaves(glob), port_before):
        np.testing.assert_array_equal(np.asarray(a), b_.numpy())
    b = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    want_loss, _ = lf(jstate["params"], b)
    assert abs(float(want_loss) - m1["loss"].item()) <= \
        1e-5 * abs(float(want_loss))


def _port_init(cfg):
    """JAX-drawn weights on a 1x1 grid: (blocked params, specs, 1, 1)."""
    specs = param_specs(cfg, 1, 1)
    return pm.init_params(specs, seed=0), specs, 1, 1
