"""The training step's options against the JAX package's, three steps on
a 1x1 plan (the reduced hybrid config: attention, mamba, MLP and MoE
layers): two microbatches, gradient compression, 8-bit moments; and the
optimizer alone on the same gradients.  The setting and the tolerances
are those of ``tests/test_torch_train_step.py`` (its docstring states
each).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import apply_updates as jax_apply
from repro.optim.adamw import init_state as jax_init_state
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.tree import leaves

from test_torch_train_step import OPT, _rel, _run, mesh11  # noqa: F401


def test_three_steps_with_two_microbatches_match_jax(mesh11):
    diffs, _, _ = _run(mesh11, "hybrid", microbatches=2)
    assert max(diffs.values()) <= 2e-5, diffs


def test_three_steps_with_grad_compression_match_jax(mesh11):
    diffs, oj, ot = _run(mesh11, "hybrid", compress=True)
    assert max(diffs.values()) <= OPT["lr"], diffs
    # the error-feedback residuals moved
    assert max(float(r.abs().max()) for r in leaves(ot["resid"])) > 0


def test_three_steps_with_8bit_moments_match_jax(mesh11):
    diffs, oj, ot = _run(mesh11, "hybrid", bits=8)
    assert max(diffs.values()) <= 10 * OPT["lr"], diffs
    codes_j = [np.asarray(x, np.int32) for x in jax.tree.leaves(oj)
               if x.dtype == jnp.int8]
    codes_t = [x.numpy().astype(np.int32) for x in leaves(ot)
               if x.dtype == torch.int8]
    assert len(codes_j) == len(codes_t) > 0
    for a, b in zip(codes_j, codes_t):
        assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("bits", [32, 8])
def test_optimizer_alone_matches_jax(bits):
    """The same gradients into both optimizers, three steps, a decay mask
    and a leaf whose size is not a multiple of the 128-block."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 64, 40), "b": (1000,), "c": (7, 33)}
    mask = {"a": True, "b": False, "c": True}
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, state_bits=bits,
              eps=1e-6)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sj, st = jax_init_state(pj, JaxAdamW(**kw)), init_state(pt,
                                                            AdamWConfig(**kw))
    upd = jax.jit(lambda p, g, s: jax_apply(p, g, s, JaxAdamW(**kw),
                                            decay_mask=mask))
    for _ in range(3):
        g = {k: (rng.standard_normal(s)
                 * 10.0 ** rng.uniform(-6, 1, size=s)).astype(np.float32)
             for k, s in shapes.items()}
        pj, sj, mj = upd(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj)
        pt, st, mt = apply_updates(pt, {k: torch.from_numpy(v)
                                        for k, v in g.items()}, st,
                                   AdamWConfig(**kw), decay_mask=mask)
        assert _rel(mj["grad_norm"], mt["grad_norm"]) <= 1e-6
        assert _rel(mj["lr"], mt["lr"]) <= 1e-6
    for k in shapes:
        assert np.abs(np.asarray(pj[k]) - pt[k].numpy()).max() <= 1e-4
    if bits == 8:
        for a, b in zip([x for x in jax.tree.leaves(sj) if x.dtype == jnp.int8],
                        [x for x in leaves(st) if x.dtype == torch.int8]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        for a, b in zip([x for x in jax.tree.leaves(sj["m"])],
                        leaves(st["m"])):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6
