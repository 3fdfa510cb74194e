"""repro_torch's mamba steps and SSM/hybrid step bodies against the JAX
package on the same weights (fp32, CPU).

* ``mamba_chunk_step`` / ``mamba_decode_step`` against the JAX mixer
  reference ``repro.models.ref._mamba_ref`` over whole sequences: lanes
  consume their sequences at their own rates (full chunks, partial chunks
  with garbage in the padding columns, ``n_valid = 1`` riders, idle lanes),
  and every consumed position's output must equal the reference there.
* ``prefill_chunk_step`` / ``decode_step`` against the JAX bodies
  (``make_prefill_chunk_body`` / ``make_decode_step``, shard_map on the 4x4
  grid), for the reduced mamba2-780m and the ``HYBRID`` config of
  tests/test_engine_state.py: logits and the dense state the bodies leave
  in the arena.

Tolerance: rel < 1e-4 (max abs difference over max abs value) — the
16-PE grid sums its products in another order than one matmul.
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
from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import _mamba_ref, gather_params
from repro.partition import DATA
from repro.serve.decode import (PagedKV, make_decode_step,
                                make_prefill_chunk_body, paged_cache_pspecs,
                                paged_cache_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params, stored_heads
from repro_torch.models.ssm import mamba_chunk_step, mamba_decode_step
from repro_torch.serve.decode import decode_step, prefill_chunk_step
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           attn_block_kv=32)
HYBRID = JModelConfig(
    name="hyb", family="hybrid", d_model=64, n_layers=2, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=128, d_inner=128, ssm_heads=8,
    ssm_headdim=16, ssm_state=16, ssm_groups=4,
    layer_pattern=(("attn", "mlp"), ("mamba", "mlp")), sub_quadratic=True,
    **F32)
CONFIGS = {"mamba2": reduced(get_config("mamba2-780m")), "hybrid": HYBRID}
S_MAX = 32
TOL = 1e-4


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def _mamba_leaves(cfg, rng):
    """Random global mamba mixer leaves (numpy), biases and scales not at
    their init values so that every term is exercised."""
    D, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn, K = cfg.ssm_groups * cfg.ssm_state, cfg.conv_kernel
    n = lambda *shape, s=1.0: (rng.normal(size=shape) * s).astype(np.float32)
    return {"wz": n(D, di, s=D ** -.5), "wx": n(D, di, s=D ** -.5),
            "wb": n(D, gn, s=D ** -.5), "wc": n(D, gn, s=D ** -.5),
            "wdt": n(D, H, s=D ** -.5), "conv_w": n(K, di + 2 * gn, s=.5),
            "conv_b": n(di + 2 * gn, s=.1),
            "A": -np.exp(rng.uniform(np.log(.5), np.log(8.), H))
            .astype(np.float32),
            "dt_bias": n(H, s=.5), "D": 1 + n(H, s=.1),
            "ssm_norm": 1 + n(di, s=.1), "wo": n(di, D, s=di ** -.5)}


# ---------------------------------------------------------------------------
# The mamba steps against the JAX mixer reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mamba_chunk_step_matches_jax_reference(name):
    jcfg = CONFIGS[name]
    tcfg = torch_config(jcfg)
    B, S, L, D = 4, 32, 8, jcfg.d_model
    rng = np.random.default_rng(1)
    jp = _mamba_leaves(tcfg, rng)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    xs = rng.normal(size=(B, S, D)).astype(np.float32)
    want = np.asarray(jax.jit(_mamba_ref, static_argnums=0)(
        jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(xs)))
    # per-launch valid counts: full chunks, partial chunks, n_valid = 1
    # riders and an idle lane (0)
    schedule = [[8, 5, 1, 0], [8, 3, 1, 7], [8, 8, 1, 0], [0, 8, 1, 8]]
    conv_ch = tcfg.d_inner + 2 * tcfg.ssm_groups * tcfg.ssm_state
    state = (torch.zeros(B, tcfg.conv_kernel - 1, conv_ch),
             torch.zeros(B, tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_headdim))
    cur = np.zeros(B, int)
    for n_valid in schedule:
        x = rng.normal(size=(B, L, D)).astype(np.float32) * 3  # garbage pad
        for b, n in enumerate(n_valid):
            x[b, :n] = xs[b, cur[b]:cur[b] + n]
        out, state = mamba_chunk_step(tp, torch.from_numpy(x), state, tcfg,
                                      torch.tensor(n_valid, dtype=torch.int32))
        for b, n in enumerate(n_valid):
            if n:
                assert _rel(want[b, cur[b]:cur[b] + n],
                            out[b, :n].numpy()) < TOL, (b, cur[b], n)
        cur += n_valid
    # decode continues every lane exactly where its chunks left it
    for _ in range(3):
        x = np.stack([xs[b, cur[b]] for b in range(B)])[:, None]
        out, state = mamba_decode_step(tp, torch.from_numpy(x), state, tcfg)
        for b in range(B):
            assert _rel(want[b, cur[b]], out[b, 0].numpy()) < TOL, (b, cur[b])
        cur += 1


# ---------------------------------------------------------------------------
# The step bodies against the JAX bodies.
# ---------------------------------------------------------------------------

def _port_dense(entry, jcfg, q=4, r=4):
    """A JAX dense arena entry (grid row 0's r column shards, every row is
    a replica) in the port's layout: conv channels back in the global
    ``[x | B | C]`` order, heads concatenated over the columns."""
    conv = np.asarray(entry["conv"])[:, :r]          # (G, r, n, k-1, cl)
    di, gn = jcfg.d_inner // r, jcfg.ssm_groups * jcfg.ssm_state // r
    parts = [conv[..., :di], conv[..., di:di + gn], conv[..., di + gn:]]
    conv = np.concatenate([p[:, j] for p in parts for j in range(r)],
                          axis=-1)
    ssm = np.asarray(entry["ssm"])[:, :r]            # (G, r, n, H/r, N, P)
    G, _, n = ssm.shape[:3]
    ssm = ssm.transpose(0, 2, 1, 3, 4, 5).reshape(G, n, -1, *ssm.shape[4:])
    return {"conv": conv, "ssm": ssm}


def _check_dense(jarena, tarena, jcfg):
    """Every slot row of the pool; the port's arena has one scratch row
    past it (repro_torch.serve.decode)."""
    for posn, (mixer, _) in enumerate(jcfg.pattern()):
        if mixer != "mamba":
            continue
        want = _port_dense(jarena[posn], jcfg)
        for leaf in ("conv", "ssm"):
            n = want[leaf].shape[1]
            assert _rel(want[leaf], tarena[posn][leaf][:, :n].numpy()) \
                < TOL, leaf


def _setup(jcfg, mesh, plan, paged, n_slots, specs):
    host = pm.init_params(specs, seed=0)
    dev = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                       host, pm.param_pspecs(specs))
    gp = jax.tree.map(np.asarray, gather_params(host, specs, 4, 4))
    tcfg = torch_config(jcfg)
    tparams = from_jax_params(gp, tcfg, device="cpu")
    jarena = jax.tree.map(
        lambda sd, sp: jax.device_put(jnp.zeros(sd.shape, sd.dtype),
                                      NamedSharding(mesh, sp)),
        paged_cache_specs(jcfg, plan, paged, n_dense_slots=n_slots),
        paged_cache_pspecs(jcfg))
    sspecs = layer_state_specs(tcfg, stride=paged.block_pos_stride,
                               kvh=stored_heads(tparams, tcfg)[1])
    tarena = StateStore(sspecs, n_blocks=paged.n_blocks,
                        device=torch.device("cpu"), n_slots=n_slots,
                        stride=paged.block_pos_stride).arena
    return dev, tcfg, tparams, jarena, tarena


def _operands(jcfg, B, T, stride, rng):
    """A scrambled table (hybrid only), scrambled slots with one idle lane."""
    has_attn = any(m == "attn" for m, _ in jcfg.pattern())
    table = np.arange(B * T, dtype=np.int32)
    rng.shuffle(table)
    table = table.reshape(B, T)
    table[3] = -1
    slots = np.array([2, 0, 3, -1], np.int32)
    return (table if has_attn else None), slots


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunk_then_decode_bodies_match_jax(mesh16, plan16, name):
    """Two chunk launches (full, partial and n_valid = 1 lanes, one idle
    lane) and then three decode steps through the same arena: logits of
    every live lane and the dense state left in every slot agree."""
    jcfg = CONFIGS[name]
    B, stride, L, n_slots = 4, 4, 8, 5
    T = S_MAX // stride
    paged = PagedKV(n_blocks=B * T, block_pos_stride=stride)
    body, in_specs, out_specs, specs, _ = make_prefill_chunk_body(
        jcfg, mesh16, plan16, batch=B, s_max=S_MAX, chunk=L, paged=paged,
        kernel_backend="jnp")
    jchunk = jax.jit(jax.shard_map(body, mesh=mesh16, in_specs=in_specs,
                                   out_specs=out_specs, check_vma=False))
    jdecode, _, _ = make_decode_step(
        jcfg, mesh16, plan16, batch=B, s_max=S_MAX, mode="gemv",
        per_slot=True, paged=paged, kernel_backend="jnp")
    params_d, tcfg, tparams, jarena, tarena = _setup(
        jcfg, mesh16, plan16, paged, n_slots, specs)
    rng = np.random.default_rng(3)
    table, slots = _operands(jcfg, B, T, stride, rng)
    put = lambda a, s: jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh16, s))
    t_ = torch.from_numpy
    jops = ([put(table, P(DATA, None))] if table is not None else []) \
        + [put(slots, P(DATA))]
    tops = (None if table is None else t_(table), t_(slots))
    live = slots >= 0
    pos = np.zeros(B, np.int32)
    for n_valid in (np.array([L, 5, 1, 0], np.int32),
                    np.array([6, 8, 1, 0], np.int32)):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, L)).astype(np.int32)
        lj, jarena = jchunk(params_d, jarena, put(toks, P(DATA, None)),
                            put(pos, P(DATA)), put(n_valid, P(DATA)), *jops)
        lt = prefill_chunk_step(tcfg, tparams, tarena, t_(toks), t_(pos),
                                t_(n_valid), *tops, stride=stride)
        assert _rel(np.asarray(lj)[live], lt.numpy()[live]) < TOL
        _check_dense(jarena, tarena, jcfg)
        pos = pos + n_valid
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, size=B).astype(np.int32)
        lj, jarena = jdecode(params_d, jarena, put(toks, P(DATA)),
                             put(pos, P(DATA)), *jops)
        lt = decode_step(tcfg, tparams, tarena, t_(toks), t_(pos), *tops,
                         stride=stride)
        assert _rel(np.asarray(lj)[live], lt.numpy()[live]) < TOL
        _check_dense(jarena, tarena, jcfg)
        pos = pos + 1
    # the idle lane wrote nothing: slot 1 and slot 4 are still zero
    for posn, (mixer, _) in enumerate(jcfg.pattern()):
        if mixer == "mamba":
            for leaf in ("conv", "ssm"):
                assert not tarena[posn][leaf][:, [1, 4]].any()
