"""The port's fixed-batch decode path and ``make_prefill`` against the JAX
package.

``repro_torch.serve.decode.make_decode_step`` (no ``paged``) in its three
modes, over the contiguous cache of ``cache_specs``, held against

* JAX ``make_decode_step`` on a 1x1 plan (``MeshPlan((data, model), (1, 1),
  1, 1)``, where every grid collective is the identity) on the same
  weights and tokens, step by step, logits and cache: ``tests/
  test_decode.py``'s cases (HYBRID: attention + mlp, mamba + MoE, in
  batched, gemv and longctx, each against the same JAX mode; DENSE with
  qk-norm in gemv), the reduced qwen2-0.5b (QKV bias, GQA), mamba2-780m
  and qwen3-moe-235b-a22b in all three, and one ``per_slot`` run with
  staggered positions and in-step ``reset`` wipes;
* ``repro.models.ref.forward_ref``, the single-device oracle, on the whole
  token sequence (teacher forcing), in all three modes.  ``forward_ref``
  reads a 4x4 grid's stored head geometry; where that differs from the
  native one (qwen2's 2 kv heads stored as 4) the oracle gets the native
  weights with each kv head repeated for its replica, which is the same
  function.

``make_prefill`` (the training forward, last position's logits) is held
against ``forward_ref`` on ``tests/test_prefill.py``'s families: dense,
MoE (the reduced qwen3-moe) and hybrid.  fp32 throughout; MoE parity pins
``capacity_factor`` 16, as ``models/ref.py`` does.

Tolerances (fp32, max abs error over the largest logit): 1e-5 against
JAX ``make_decode_step`` and against ``forward_ref`` (the oracle runs the
whole sequence at once: attention, the SSD scan and the MoE sums in other
orders; measured: at most 7.7e-7 and 9.3e-7).  Weights are drawn with
numpy by the JAX initializer's rules (``init_numpy``), and each JAX step
is compiled once per module.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models import params as pm
from repro.models.ref import forward_ref, gather_params
from repro.partition import DATA, MODEL, MeshPlan
from repro.serve.decode import (cache_pspecs, cache_specs as j_cache_specs,
                                make_decode_step as j_make_decode_step)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params, stored_heads
from repro_torch.serve.decode import (DECODE_MODES, cache_specs,
                                      make_decode_step, make_prefill)

from test_decode import DENSE, HYBRID

B, S_MAX, STEPS = 4, 32, 8
JAX_TOL = 1e-5
REF_TOL = 1e-5
MODES = list(DECODE_MODES)
PLAN11 = MeshPlan((DATA, MODEL), (1, 1), 1, 1)

CONFIGS = {
    "hybrid": HYBRID,
    "dense": DENSE,
    "qwen2": j_reduced(j_get_config("qwen2-0.5b")),
    "mamba2": j_reduced(j_get_config("mamba2-780m")),
    "qwen3-moe": dataclasses.replace(
        j_reduced(j_get_config("qwen3-moe-235b-a22b")), capacity_factor=16.0),
}


def init_numpy(specs, seed: int = 0):
    """The JAX parameter tree of ``specs``, drawn with numpy by
    ``repro.models.params._init_leaf``'s rules (normal with scale
    fan_in^-1/2 or ``init_scale``, zeros, ones, the SSD decay ``-exp(U(log
    .5, log 8))``): the same distributions as ``pm.init_params`` without
    its one compile per leaf shape.  For grids with no kv column replicas
    to tie (a 1x1 grid has none)."""
    specs_flat, treedef = jax.tree.flatten(
        specs, is_leaf=lambda x: isinstance(x, pm.ParamSpec))
    rng = np.random.default_rng(seed)
    out = []
    for s in specs_flat:
        assert s.col_replicas == 1, s
        if s.init in ("zeros", "ones"):
            a = (np.ones if s.init == "ones" else np.zeros)(s.shape,
                                                            np.float32)
        elif s.init == "normal":
            scale = s.init_scale if s.fan_in is None else s.fan_in ** -0.5
            a = rng.standard_normal(s.shape, np.float32) * scale
        elif s.init == "ssm_a":
            a = -np.exp(rng.uniform(np.log(0.5), np.log(8.0), s.shape))
        else:
            raise ValueError(s.init)
        out.append(jnp.asarray(a.astype(np.float32), dtype=s.dtype))
    return jax.tree.unflatten(treedef, out)


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


class Model:
    """One config's JAX weights at 1x1, the port's copy, the token
    sequence, and the JAX oracle's logits of it."""

    def __init__(self, name, mesh):
        self.mesh = mesh
        self.jcfg = CONFIGS[name]
        self.tcfg = torch_config(self.jcfg)
        self.specs = None
        self._steps = {}
        self.toks = np.random.default_rng(0).integers(
            0, self.jcfg.vocab_size, size=(B, STEPS)).astype(np.int32)

    def step(self, mode, per_slot=False):
        key = (mode, per_slot)
        if key not in self._steps:
            step, specs, pctx = j_make_decode_step(
                self.jcfg, self.mesh, PLAN11, batch=B, s_max=S_MAX,
                mode=mode, per_slot=per_slot)
            self._steps[key] = (step, pctx)
            if self.specs is None:
                self.specs = specs
                host = init_numpy(specs, seed=0)
                self.jparams = jax.tree.map(
                    lambda a, s: jax.device_put(a, NamedSharding(self.mesh,
                                                                 s)),
                    host, pm.param_pspecs(specs))
                self.gp = jax.tree.map(np.asarray,
                                       gather_params(host, specs, 1, 1))
                self.params = from_jax_params(self.gp, self.tcfg,
                                              device="cpu")
        return self._steps[key]

    def jax_cache(self, mode, pctx):
        return jax.tree.map(
            lambda sd, sp: jax.device_put(jnp.zeros(sd.shape, sd.dtype),
                                          NamedSharding(self.mesh, sp)),
            j_cache_specs(self.jcfg, PLAN11, B, S_MAX, mode),
            cache_pspecs(self.jcfg, mode, pctx.data_axes))

    def put(self, a, mode):
        spec = P() if mode == "longctx" else P(DATA)
        return jax.device_put(jnp.asarray(a), NamedSharding(self.mesh, spec))

    def ref_logits(self):
        """forward_ref's logits of the whole sequence (B, STEPS, Vpad)."""
        if not hasattr(self, "_ref"):
            self.step("gemv")
            gp = _grid_geometry(self.jcfg, self.gp)
            x, _ = jax.jit(partial(forward_ref, self.jcfg))(
                gp, {"tokens": jnp.asarray(self.toks)})
            self._ref = np.asarray((x @ gp["lm_head"]).astype(jnp.float32))
        return self._ref


def _grid_geometry(cfg, gp):
    """Native (1x1) weights in the 4x4 grid's stored head geometry, which
    ``forward_ref`` reads: each kv head repeated for its column replicas
    (query head h reads stored kv head h // (Hq / stored), which holds kv
    head h // (Hq / kvh)).  Padded q heads never arise here."""
    has_attn = any(m == "attn" for m, _ in cfg.pattern())
    if not has_attn:
        return gp
    assert cfg.heads_padded(4) == cfg.n_heads
    rep = cfg.kv_stored(4)[1]
    if rep == 1:
        return gp
    hd = cfg.hd()

    def widen(a, axis):
        shape = a.shape[:axis] + (a.shape[axis] // hd, hd) + a.shape[axis + 1:]
        a = np.repeat(a.reshape(shape), rep, axis=axis)
        return a.reshape(a.shape[:axis] + (-1,) + a.shape[axis + 2:])

    out = dict(gp, layers=[])
    for entry in gp["layers"]:
        m = dict(entry["mixer"])
        for name in ("wk", "wv", "bk", "bv"):
            if name in m:
                m[name] = widen(m[name], m[name].ndim - 1)
        out["layers"].append(dict(entry, mixer=m))
    return out


@pytest.fixture(scope="module")
def models(mesh11):
    built = {}

    def get(name):
        if name not in built:
            built[name] = Model(name, mesh11)
        return built[name]
    return get


def _port_run(m, mode, params, cfg, kvh=None):
    cache = cache_specs(cfg, B, S_MAX, mode, kvh=kvh, device="cpu")
    step = make_decode_step(cfg, batch=B, s_max=S_MAX, mode=mode)
    out = []
    for t in range(STEPS):
        out.append(step(params, cache, torch.from_numpy(m.toks[:, t]), t))
    return torch.cat(out, 1).numpy(), cache


JAX_CASES = [("hybrid", mode) for mode in MODES] + [("dense", "gemv")] + [
    (name, mode) for name in ("qwen2", "mamba2", "qwen3-moe")
    for mode in MODES]


@pytest.mark.parametrize("name,mode", JAX_CASES)
def test_decode_matches_jax_make_decode_step(models, name, mode):
    m = models(name)
    step, pctx = m.step(mode)
    cache = m.jax_cache(mode, pctx)
    want = []
    for t in range(STEPS):
        logits, cache = step(m.jparams, cache, m.put(m.toks[:, t], mode),
                             jnp.int32(t))
        want.append(np.asarray(logits))
    want = np.concatenate(want, 1)
    got, tcache = _port_run(m, mode, m.params, m.tcfg)
    assert got.shape == want.shape
    assert _rel(want, got) <= JAX_TOL, _rel(want, got)
    # the caches agree too: K/V rows written, conv/ssm states carried
    jc = jax.tree.map(np.asarray, cache)
    for jentry, tentry in zip(jc, tcache):
        for leaf, t in tentry.items():
            assert _rel(jentry[leaf][:, 0], t.numpy()) <= JAX_TOL, leaf


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_forward_ref(models, name, mode):
    """Teacher forcing: step t's logits are the oracle's at position t."""
    m = models(name)
    want = m.ref_logits()
    gp = _grid_geometry(m.jcfg, m.gp)
    params = from_jax_params(gp, m.tcfg, device="cpu")
    got, _ = _port_run(m, mode, params, m.tcfg,
                       kvh=stored_heads(params, m.tcfg)[1] or None)
    assert _rel(want, got) <= REF_TOL, _rel(want, got)


def test_per_slot_decode_with_resets_matches_jax(models):
    """Slots at their own positions (a vector ``pos``), two of them
    recycled mid-run by ``reset`` (the step wipes their cache rows before
    it runs): the logits equal the JAX per-slot step's, and a recycled
    slot's equal a fresh run of its new tokens from position 0."""
    m = models("hybrid")
    step, pctx = m.step("gemv", per_slot=True)
    jcache = m.jax_cache("gemv", pctx)
    tstep = make_decode_step(m.tcfg, batch=B, s_max=S_MAX, mode="gemv",
                             per_slot=True)
    tcache = cache_specs(m.tcfg, B, S_MAX, "gemv", device="cpu")
    start = np.array([0, 2, 0, 5], np.int32)       # slot b restarts here
    outs = []
    for t in range(STEPS):
        pos = np.where(t >= start, t - start, t).astype(np.int32)
        reset = (t == start) & (start > 0)
        jl, jcache = step(m.jparams, jcache, m.put(m.toks[:, t], "gemv"),
                          m.put(pos, "gemv"), m.put(reset.astype(np.int32),
                                                    "gemv"))
        tl = tstep(m.params, tcache, torch.from_numpy(m.toks[:, t]),
                   torch.from_numpy(pos),
                   torch.from_numpy(reset.astype(np.int32)))
        assert _rel(np.asarray(jl), tl.numpy()) <= JAX_TOL, t
        outs.append(tl[:, 0].numpy())
    # slot 3 restarted at step 5: its last three rows are a fresh run
    fresh = cache_specs(m.tcfg, B, S_MAX, "gemv", device="cpu")
    scalar = make_decode_step(m.tcfg, batch=B, s_max=S_MAX, mode="gemv")
    for t in range(5, STEPS):
        row = scalar(m.params, fresh, torch.from_numpy(m.toks[:, t]), t - 5)
        assert _rel(row[3, 0].numpy(), outs[t][3]) <= JAX_TOL


def test_mode_checks_follow_the_jax_package():
    cfg = torch_config(HYBRID)
    with pytest.raises(NotImplementedError, match="per-slot"):
        make_decode_step(cfg, batch=B, s_max=S_MAX, mode="longctx",
                         per_slot=True)
    with pytest.raises(ValueError, match="mode"):
        make_decode_step(cfg, batch=B, s_max=S_MAX, mode="summa")
    with pytest.raises(ValueError, match="mode"):
        cache_specs(cfg, B, S_MAX, "paged", device="cpu")
    shapes = [{k: tuple(v.shape) for k, v in e.items()}
              for e in cache_specs(cfg, B, S_MAX, "gemv", device="cpu")]
    assert shapes == [
        {"k": (1, B, S_MAX, 4, 8), "v": (1, B, S_MAX, 4, 8)},
        {"conv": (1, B, 3, 128 + 2 * 4 * 16), "ssm": (1, B, 8, 16, 16)}]


@pytest.mark.parametrize("name", ["dense", "qwen3-moe", "hybrid"])
def test_make_prefill_matches_forward_ref(models, name):
    """The last position's logits of the training forward (the families of
    tests/test_prefill.py)."""
    m = models(name)
    want = m.ref_logits()[:, -1]
    gp = _grid_geometry(m.jcfg, m.gp)
    got = make_prefill(m.tcfg)(from_jax_params(gp, m.tcfg, device="cpu"),
                               {"tokens": torch.from_numpy(m.toks)})
    assert got.shape == (B, 1, want.shape[-1]) and got.dtype == torch.float32
    assert _rel(want, got[:, 0].numpy()) <= REF_TOL
