"""repro_torch model math against the JAX package on the same inputs.

Inputs come from a seeded numpy generator and go through both the JAX
function and its PyTorch counterpart, in fp32 on the CPU.  Tolerance: rel
< 1e-6 (max abs difference over max abs value): the two frameworks round
the same fp32 operations, in a different order only inside reductions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ref as jref
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 96)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=96).astype(np.float32),
         "bias": rng.normal(size=96).astype(np.float32)}
    cfg = JModelConfig(name="n", family="dense", d_model=96, n_layers=1,
                       norm=norm)
    want = jref._norm_ref(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    if norm == "rmsnorm":
        got = tlayers.rms_norm(_t(x), _t(p["scale"]))
    else:
        got = tlayers.layer_norm(_t(x), _t(p["scale"]), _t(p["bias"]))
    assert _rel(want, got) < TOL


def test_rms_norm_local_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    s = rng.normal(size=16).astype(np.float32)
    want = jlayers.rms_norm_local(jnp.asarray(x), jnp.asarray(s))
    got = tlayers.rms_norm_local(_t(x), _t(s))
    assert _rel(want, got) < TOL


@pytest.mark.parametrize("hd", [8, 64, 128])
def test_rope_matches_at_long_positions(hd):
    """Positions up to 4096: the frequencies must be bit-identical or the
    angle error grows with the position."""
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4096, size=(3, 11)).astype(np.int32)
    x = rng.normal(size=(3, 11, 4, hd)).astype(np.float32)
    jc, js = jlayers.rope_tables(jnp.asarray(pos), hd, 1e6)
    tc, ts = tlayers.rope_tables(_t(pos), hd, 1e6)
    assert _rel(jc, tc) < TOL and _rel(js, ts) < TOL
    want = jlayers.apply_rope(jnp.asarray(x), jc, js)
    got = tlayers.apply_rope(_t(x), tc, ts)
    assert _rel(want, got) < TOL


def test_swiglu_matches():
    rng = np.random.default_rng(3)
    g, u = (rng.normal(size=(4, 33)).astype(np.float32) * 4 for _ in range(2))
    want = jlayers.swiglu(jnp.asarray(g), jnp.asarray(u))
    got = tlayers.swiglu(_t(g), _t(u))
    assert _rel(want, got) < TOL


@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_partial_and_combine_match(per_slot):
    """GQA partials over labelled keys, some rows fully masked (they carry
    m = -1e30 in both), then the one-device merge."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, Sq, Skv, D = 2, 8, 2, 3, 12, 16
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    if per_slot:
        q_pos = np.array([[0, 4, 9], [2, 3, 11]], np.int32)
        kv_pos = rng.integers(0, 14, size=(B, Skv)).astype(np.int32)
        kv_pos[1, :] = np.maximum(kv_pos[1, :], 3)   # slot 1 row 0 all masked
    else:
        q_pos = np.array([0, 5, 11], np.int32)
        kv_pos = np.arange(Skv, dtype=np.int32)
    jp = jattn.attention_partial(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_pos=jnp.asarray(kv_pos),
                                 q_pos=jnp.asarray(q_pos))
    tp = tattn.attention_partial(_t(q), _t(k), _t(v), kv_pos=_t(kv_pos),
                                 q_pos=_t(q_pos))
    for a, b in zip(jp, tp):
        assert _rel(a, b) < TOL
    want = jattn.combine_partials(jp, lambda t: t, lambda t: t)
    assert _rel(want, tattn.combine_partials(tp)) < TOL
    assert np.isfinite(tattn.combine_partials(tp).numpy()).all()
