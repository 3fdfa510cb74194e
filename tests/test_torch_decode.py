"""repro_torch step bodies against the JAX step bodies on the same weights.

The JAX bodies run through shard_map on the 4x4 grid (``mesh16`` /
``plan16``); their parameters go through ``gather_params`` -> numpy ->
``repro_torch.models.params.from_jax_params``, so the port computes with
the r=4 storage (q heads padded, kv heads replicated).  Both run in fp32 on
the CPU over scrambled block tables with idle slots, partial chunks and
``n_valid = 1`` decode riders.

Tolerances: logits rel < 1e-4 (max abs difference over max abs value) —
the 16-PE gemv2d sums its products in another order than one matmul; the
K/V the bodies write into their arenas rel < 1e-5.
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
from repro.models.ref import gather_params
from repro.partition import DATA
from repro.serve.decode import (PagedKV, make_decode_step,
                                make_prefill_chunk_body, paged_cache_pspecs,
                                paged_cache_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params, stored_heads
from repro_torch.serve.decode import decode_step, prefill_chunk_step
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs

F32 = dict(param_dtype=jnp.float32, compute_dtype=jnp.float32,
           attn_block_kv=32)
CONFIGS = {
    # the tests/test_paged_kernel.py attention config (qk_norm, GQA 8/4)
    "qk_norm": JModelConfig(name="pk-attn", family="dense", d_model=64,
                            n_layers=2, n_heads=8, n_kv_heads=4, d_ff=128,
                            vocab_size=128, qk_norm=True, **F32),
    # reduced qwen2: qkv bias, 2 kv heads stored replicated to 4 at r=4
    "qkv_bias": reduced(get_config("qwen2-0.5b")),
}
S_MAX = 32
LOGIT_TOL, KV_TOL = 1e-4, 1e-5


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def _params(jcfg, specs, mesh):
    """JAX params (seed 0, random qkv biases) on the mesh, and the port's
    copy of the same global weights."""
    host = pm.init_params(specs, seed=0)
    if jcfg.qkv_bias:            # JAX initialises biases to zero
        rng = np.random.default_rng(7)
        for lp in host["layers"]:
            for name in ("bq", "bk", "bv"):
                shape = lp["mixer"][name].shape
                lp["mixer"][name] = jnp.asarray(
                    rng.normal(size=shape).astype(np.float32) * 0.5)
    dev = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                       host, pm.param_pspecs(specs))
    gp = jax.tree.map(np.asarray, gather_params(host, specs, 4, 4))
    tcfg = torch_config(jcfg)
    return dev, from_jax_params(gp, tcfg, device="cpu"), tcfg


def _arenas(jcfg, mesh, plan, paged, tcfg, tparams):
    jarena = jax.tree.map(
        lambda sd, sp: jax.device_put(jnp.zeros(sd.shape, sd.dtype),
                                      NamedSharding(mesh, sp)),
        paged_cache_specs(jcfg, plan, paged), paged_cache_pspecs(jcfg))
    specs = layer_state_specs(tcfg, stride=paged.block_pos_stride,
                              kvh=stored_heads(tparams, tcfg)[1])
    tarena = StateStore(specs, n_blocks=paged.n_blocks,
                        device=torch.device("cpu")).arena
    return jarena, tarena


def _port_layout(jarena, q=4, r=4):
    """JAX arena leaves (G, q*r, n_loc, stride, kvh_loc, hd), page p on row
    p % q at local p // q and kv head j*kvh_loc + h on column j, in the
    port's (G, n_blocks, stride, kvh, hd) layout."""
    out = []
    for entry in jarena:
        e = {}
        for name, leaf in entry.items():
            a = np.asarray(leaf)
            G, _, n_loc, s, kl, hd = a.shape
            a = a.reshape(G, q, r, n_loc, s, kl, hd).transpose(
                0, 3, 1, 4, 2, 5, 6)
            e[name] = a.reshape(G, n_loc * q, s, r * kl, hd)
        out.append(e)
    return out


def _check_arenas(jarena, tarena):
    """Every page of the pool; the port's arena has one scratch page past
    it (repro_torch.serve.decode)."""
    for je, te in zip(_port_layout(jarena), tarena):
        for name in je:
            n = je[name].shape[1]
            assert _rel(je[name], te[name][:, :n].numpy()) < KV_TOL, name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_steps_match_jax(mesh16, plan16, name):
    """Per-slot decode on a scrambled table: three slots at staggered
    positions and one idle slot (table row -1, which writes nothing)."""
    jcfg = CONFIGS[name]
    B, stride, steps = 4, 8, 6
    T = S_MAX // stride
    paged = PagedKV(n_blocks=B * T, block_pos_stride=stride)
    step, specs, _ = make_decode_step(
        jcfg, mesh16, plan16, batch=B, s_max=S_MAX, mode="gemv",
        per_slot=True, paged=paged, kernel_backend="jnp")
    params_d, tparams, tcfg = _params(jcfg, specs, mesh16)
    jarena, tarena = _arenas(jcfg, mesh16, plan16, paged, tcfg, tparams)
    table = np.arange(B * T, dtype=np.int32)
    np.random.default_rng(5).shuffle(table)
    table = table.reshape(B, T)
    table[3] = -1                                   # idle slot
    offset = np.array([0, 3, 9, 0], np.int32)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, steps)).astype(np.int32)
    put = lambda a, s: jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh16, s))
    t_ = torch.from_numpy
    for t in range(steps):
        pos = offset + t
        lj, jarena = step(params_d, jarena, put(toks[:, t], P(DATA)),
                          put(pos, P(DATA)), put(table, P(DATA, None)))
        lt = decode_step(tcfg, tparams, tarena, t_(toks[:, t].copy()),
                         t_(pos), t_(table), stride=stride)
        assert lt.shape == lj.shape and lt.dtype == torch.float32
        # the idle slot's logits are never read (its attention sees only
        # masked keys); every live slot must agree
        assert _rel(np.asarray(lj)[:3], lt.numpy()[:3]) < LOGIT_TOL, t
    _check_arenas(jarena, tarena)


@pytest.mark.parametrize("all_logits", [False, True],
                         ids=["last", "all_logits"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_chunks_match_jax(mesh16, plan16, name, all_logits):
    """Two chunk launches on a scrambled table: a full chunk, partial
    chunks (n_valid < L) and an n_valid = 1 decode rider in one launch,
    then every slot continues from where it stopped."""
    jcfg = CONFIGS[name]
    B, stride, L = 4, 4, 8
    T = S_MAX // stride
    paged = PagedKV(n_blocks=B * T, block_pos_stride=stride)
    body, in_specs, out_specs, specs, _ = make_prefill_chunk_body(
        jcfg, mesh16, plan16, batch=B, s_max=S_MAX, chunk=L, paged=paged,
        kernel_backend="jnp", all_logits=all_logits)
    jbody = jax.jit(jax.shard_map(body, mesh=mesh16, in_specs=in_specs,
                                  out_specs=out_specs, check_vma=False))
    params_d, tparams, tcfg = _params(jcfg, specs, mesh16)
    jarena, tarena = _arenas(jcfg, mesh16, plan16, paged, tcfg, tparams)
    table = np.arange(B * T, dtype=np.int32)
    np.random.default_rng(9).shuffle(table)
    table = table.reshape(B, T)
    rng = np.random.default_rng(3)
    put = lambda a, s: jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh16, s))
    t_ = torch.from_numpy
    pos = np.array([0, 0, 2, 7], np.int32)          # staggered slots
    for n_valid in (np.array([L, 5, 3, 1], np.int32),
                    np.array([6, 8, 2, 1], np.int32)):
        toks = rng.integers(0, jcfg.vocab_size, size=(B, L)).astype(np.int32)
        lj, jarena = jbody(params_d, jarena, put(toks, P(DATA, None)),
                           put(pos, P(DATA)), put(n_valid, P(DATA)),
                           put(table, P(DATA, None)))
        lt = prefill_chunk_step(tcfg, tparams, tarena, t_(toks), t_(pos),
                                t_(n_valid), t_(table), stride=stride,
                                all_logits=all_logits)
        lj = np.asarray(lj)
        assert lt.shape == lj.shape
        if all_logits:       # padding columns past n_valid are never read
            for b in range(B):
                n = n_valid[b]
                assert _rel(lj[b, :n], lt.numpy()[b, :n]) < LOGIT_TOL, b
        else:
            assert _rel(lj, lt.numpy()) < LOGIT_TOL
        pos = pos + n_valid
    _check_arenas(jarena, tarena)
