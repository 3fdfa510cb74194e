"""repro_torch's step bodies against the JAX bodies in bf16.

The other parity tests run fp32 only; the card serves bf16.  Here the
reduced qwen2-0.5b, mamba2-780m and qwen3-moe-235b-a22b configs run in
bf16 (weights and compute), port against JAX on the same weights: two
chunk launches (every position's logits) and three decode steps through
the same arena, on the CPU.  The JAX bodies run on a 1x1 grid
(``MeshPlan((data, model), (1, 1), 1, 1)``), so no grid summation order
stands between the two; capacity and the MoE wire then follow the same
formula on both sides.

Two builds of each JAX body:

* with ``xla_allow_excess_precision`` off, XLA rounds every bf16 result
  where the program says so, as PyTorch does.  What is left is the order
  of the fp32 sums inside a bf16 product, which differs between XLA's dot
  and PyTorch's: where a sum lands near a bf16 rounding boundary, the
  rounded element differs by one ulp, and a state that holds it carries
  the difference on.  Logits and the arena must agree within
  ``ROUNDING_TOL`` = 2^-7, two bf16 ulps of the largest value.  (Measured
  on this input: qwen2 and qwen3-moe agree to 2e-7, fp32 noise; mamba2
  has one flipped rounding in lane 2's in-projection, 0.0042-0.0058.)
* with XLA's default (excess precision allowed), XLA keeps fused
  intermediates in fp32 and skips roundings that the port makes.  The
  logits then differ by a few bf16 ulps of the largest logit:
  rel < ``BF16_TOL`` = 2^-6 (four ulps of 2^-8).  This build is held
  for qwen2 and mamba2 only: on qwen3-moe the roundings XLA skips move
  the router's fp32 logits, and at a near-tie between two experts a token
  goes to another expert (one decode row then differs by 0.31 of the
  largest logit).  qwen3-moe is held by the first build, where routing
  agrees.

mamba2 also shows where its chunk/decode gap comes from: the same tokens
fed once as one chunk and once token by token through the decode body
differ in the JAX package exactly as much as in the port.  The chunk conv
runs in the activation dtype and the decode conv in fp32 in both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.partition import DATA, MODEL, MeshPlan
from repro.serve.decode import (PagedKV, make_decode_step,
                                make_prefill_chunk_body, paged_cache_pspecs,
                                paged_cache_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params, stored_heads
from repro_torch.serve.decode import decode_step, prefill_chunk_step
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs

ARCHS = {"qwen2": "qwen2-0.5b", "mamba2": "mamba2-780m",
         "qwen3_moe": "qwen3-moe-235b-a22b"}
B, STRIDE, L, N_SLOTS, S_MAX = 4, 4, 8, 5, 32
ROUNDING_TOL = 2.0 ** -7
BF16_TOL = 2.0 ** -6
NO_EXCESS = {"xla_allow_excess_precision": False}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), (DATA, MODEL),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


class Bodies:
    """One config's JAX bodies (both builds), weights and operands, and
    the port's copy of the weights."""

    def __init__(self, arch, mesh):
        self.mesh = mesh
        plan = MeshPlan((DATA, MODEL), (1, 1), 1, 1)
        self.jcfg = jcfg = dataclasses.replace(
            reduced(get_config(arch)), param_dtype=jnp.bfloat16,
            compute_dtype=jnp.bfloat16)
        T = S_MAX // STRIDE
        self.paged = PagedKV(n_blocks=B * T, block_pos_stride=STRIDE)
        body, ins, outs, specs, _ = make_prefill_chunk_body(
            jcfg, mesh, plan, batch=B, s_max=S_MAX, chunk=L,
            paged=self.paged, kernel_backend="jnp", all_logits=True)
        self.chunk = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=ins,
                                           out_specs=outs, check_vma=False))
        self.decode, _, _ = make_decode_step(
            jcfg, mesh, plan, batch=B, s_max=S_MAX, mode="gemv",
            per_slot=True, paged=self.paged, kernel_backend="jnp")
        self.plan, self.specs = plan, specs
        host = pm.init_params(specs, seed=0)
        self.params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), host,
            pm.param_pspecs(specs))
        names = {f.name for f in dataclasses.fields(ModelConfig)} \
            - {"param_dtype", "compute_dtype"}
        self.tcfg = ModelConfig(**{n: getattr(jcfg, n) for n in names},
                                param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
        gp = jax.tree.map(np.asarray, gather_params(host, specs, 1, 1))
        self.tparams = from_jax_params(gp, self.tcfg, device="cpu")
        mixers = [m for m, _ in jcfg.pattern()]
        self.has_attn = "attn" in mixers
        self.has_dense = any(m != "attn" for m in mixers)
        rng = np.random.default_rng(3)
        table = rng.permutation(B * T).astype(np.int32).reshape(B, T)
        table[3] = -1                                   # idle lane
        slots = np.array([2, 0, 3, -1], np.int32)
        self.table, self.slots = table, slots
        self.live = np.array([True, True, True, False])
        self.seq = rng.integers(0, jcfg.vocab_size,
                                size=(B, 2 * L + 4)).astype(np.int32)
        self._compiled = {}

    def put(self, a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(self.mesh, spec))

    def jops(self):
        return ([self.put(self.table, P(DATA, None))] if self.has_attn
                else []) + ([self.put(self.slots, P(DATA))]
                            if self.has_dense else [])

    def tops(self):
        t_ = torch.from_numpy
        return ((t_(self.table) if self.has_attn else None),) + (
            (t_(self.slots),) if self.has_dense else ())

    def arenas(self):
        jarena = jax.tree.map(
            lambda sd, sp: self.put(jnp.zeros(sd.shape, sd.dtype), sp),
            paged_cache_specs(self.jcfg, self.plan, self.paged,
                              n_dense_slots=N_SLOTS),
            paged_cache_pspecs(self.jcfg))
        sspecs = layer_state_specs(
            self.tcfg, stride=STRIDE,
            kvh=stored_heads(self.tparams, self.tcfg)[1])
        tarena = StateStore(sspecs, n_blocks=self.paged.n_blocks,
                            device=torch.device("cpu"), n_slots=N_SLOTS,
                            stride=STRIDE).arena
        return jarena, tarena

    def run_jax(self, kind, exact, *args):
        """The chunk or decode body, compiled once per build."""
        key = (kind, exact)
        if key not in self._compiled:
            fn = self.chunk if kind == "chunk" else self.decode
            lowered = fn.lower(*args)
            self._compiled[key] = lowered.compile(
                NO_EXCESS if exact else None)
        return self._compiled[key](*args)


@pytest.fixture(scope="module")
def bodies(mesh11):
    built = {}

    def get(name):
        if name not in built:
            built[name] = Bodies(ARCHS[name], mesh11)
        return built[name]
    return get


def _arena_rel(jarena, tarena):
    """Worst rel difference of the pool region of every leaf (q = r = 1:
    the JAX leaves are (G, 1, n, ...), the port's (G, n + 1, ...))."""
    worst = 0.0
    for je, te in zip(jarena, tarena):
        for name, leaf in je.items():
            a = _f32(leaf)[:, 0]
            worst = max(worst, _rel(a, te[name][:, :a.shape[1]].float()))
    return worst


CASES = [(name, exact) for name in sorted(ARCHS) for exact in (True, False)
         if exact or name != "qwen3_moe"]


@pytest.mark.parametrize(
    "name,exact", CASES, ids=[f"{n}-{'no_excess_precision' if e else
                                    'xla_default'}" for n, e in CASES])
def test_bf16_bodies_match_jax(bodies, name, exact):
    """Chunk launches (a full chunk, partial chunks, an n_valid = 1 rider,
    an idle lane), then decode steps: every live lane's logits agree, and
    so does the arena the bodies leave."""
    bd = bodies(name)
    tol = ROUNDING_TOL if exact else BF16_TOL
    jarena, tarena = bd.arenas()
    t_ = torch.from_numpy
    pos = np.zeros(B, np.int32)
    for n_valid in (np.array([L, 5, 1, 0], np.int32),
                    np.array([6, L, 1, 0], np.int32)):
        toks = np.stack([bd.seq[b, pos[b]:pos[b] + L] for b in range(B)])
        lj, jarena = bd.run_jax(
            "chunk", exact, bd.params, jarena, bd.put(toks, P(DATA, None)),
            bd.put(pos, P(DATA)), bd.put(n_valid, P(DATA)), *bd.jops())
        lt = prefill_chunk_step(bd.tcfg, bd.tparams, tarena, t_(toks.copy()),
                                t_(pos), t_(n_valid), *bd.tops(),
                                stride=STRIDE, all_logits=True)
        lj = _f32(lj)
        for b in np.flatnonzero(bd.live):
            n = n_valid[b]
            assert _rel(lj[b, :n], lt[b, :n].float()) < tol, (b, n)
        pos = pos + n_valid
    if exact:
        assert _arena_rel(jarena, tarena) < ROUNDING_TOL
    for _ in range(3):
        toks = bd.seq[np.arange(B), pos]
        lj, jarena = bd.run_jax("decode", exact, bd.params, jarena,
                                bd.put(toks, P(DATA)), bd.put(pos, P(DATA)),
                                *bd.jops())
        lt = decode_step(bd.tcfg, bd.tparams, tarena, t_(toks.copy()),
                         t_(pos), *bd.tops(), stride=STRIDE)
        live = bd.live
        assert _rel(_f32(lj)[live], lt.float()[live]) < tol
        pos = pos + 1
    if exact:
        assert _arena_rel(jarena, tarena) < ROUNDING_TOL


def test_mamba2_chunk_decode_gap_is_the_references(bodies):
    """The same L tokens, fed as one chunk and fed token by token through
    the decode body: the logits of the two paths differ (bf16 chunk conv,
    fp32 decode conv), and by the same amount in both packages."""
    bd = bodies("mamba2")
    t_ = torch.from_numpy
    toks = bd.seq[:, :L]
    zero = np.zeros(B, np.int32)
    full = np.array([L, L, L, 0], np.int32)
    live = bd.live
    gaps = {}
    for exact in (True, False):
        jarena, tarena = bd.arenas()
        jc, _ = bd.run_jax("chunk", exact, bd.params, jarena,
                           bd.put(toks, P(DATA, None)), bd.put(zero, P(DATA)),
                           bd.put(full, P(DATA)), *bd.jops())
        tc = prefill_chunk_step(bd.tcfg, bd.tparams, tarena,
                                t_(toks.copy()), t_(zero), t_(full),
                                *bd.tops(), stride=STRIDE, all_logits=True)
        jarena, tarena = bd.arenas()
        jd, td = [], []
        for t in range(L):
            p = np.full(B, t, np.int32)
            lj, jarena = bd.run_jax(
                "decode", exact, bd.params, jarena,
                bd.put(toks[:, t], P(DATA)), bd.put(p, P(DATA)), *bd.jops())
            jd.append(_f32(lj).reshape(B, -1))
            td.append(decode_step(bd.tcfg, bd.tparams, tarena,
                                  t_(toks[:, t].copy()), t_(p), *bd.tops(),
                                  stride=STRIDE).float().reshape(B, -1)
                      .numpy())
        jc, tc = _f32(jc)[live], tc.float().numpy()[live]
        jd, td = np.stack(jd, 1)[live], np.stack(td, 1)[live]
        gap = lambda c, d: float((np.abs(c - d)
                                  / c.std(-1, keepdims=True)).max())
        gaps[exact] = (gap(jc, jd), gap(tc, td))
    for j_gap, t_gap in gaps.values():
        assert j_gap > 1e-3                      # the gap exists ...
        assert abs(j_gap - t_gap) <= 1e-3 * j_gap  # ... and is the same
