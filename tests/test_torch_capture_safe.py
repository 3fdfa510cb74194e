"""The port's step bodies can be captured as CUDA graphs (CPU checks).

A capture records a fixed sequence of kernels, so a body may hold no host
sync and no data-dependent shape.  The port's bodies write with fixed
shapes instead: every write the JAX bodies drop (``.at[].set(
mode="drop")``) lands in one scratch page or slot row past the pool.

* a chunk step with padding columns, idle lanes and a chunk that runs past
  its slot's block table leaves every page and slot row of the pool as the
  JAX body leaves it (rel < 1e-5, as tests/test_torch_decode.py and
  tests/test_torch_ssm.py hold the arenas), bit for bit unchanged wherever
  no live position or lane writes, and its dropped writes in scratch;
* a step with every lane idle (the engine's build operands) changes only
  scratch, on an arena of random values;
* the bodies of the reduced qwen2, mamba2, hybrid, qwen3-moe and jamba
  configs run under a dispatch mode that raises on ``aten.nonzero`` (a
  data-dependent shape), ``aten._local_scalar_dense`` (``.item()``,
  ``bool(t)``, ``int(t)``) and ``aten.lift_fresh`` (a tensor made from
  Python data: a pageable host-to-device copy on the card), after one call
  outside it, as the engine's build warms a step up before capturing it.
  The plain grouped GEMM reads its offsets on the host by design; it runs
  only for CPU tensors (the card launches the kernel, which reads them on
  the card), so the guard lets it through and holds the MoE block's own
  ops.  The dispatch guard sees only the outer op, not a read-back inside
  a CUDA op's implementation (``bincount``'s): the card's ``graphs`` phase
  of chip_smoke.py is the real check.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.partition import DATA
from repro.serve.decode import PagedKV, make_prefill_chunk_body
import repro_torch.models.moe as moe_mod
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.params import init_params, stored_heads
from repro_torch.serve.decode import decode_step, prefill_chunk_step
from repro_torch.serve.engine.state_store import StateStore
from repro_torch.serve.state import layer_state_specs
from test_torch_decode import _port_layout
from test_torch_ssm import HYBRID, _port_dense, _rel, _setup, torch_config

S_MAX, B, STRIDE, L, N_SLOTS = 32, 4, 4, 8, 5
T = S_MAX // STRIDE
KV_TOL, LOGIT_TOL = 1e-5, 1e-4
JCONFIGS = {"hybrid": HYBRID, "qwen2": reduced(get_config("qwen2-0.5b"))}


def _kinds(cfg):
    mixers = [m for m, _ in cfg.pattern()]
    return "attn" in mixers, "mamba" in mixers


def _written(table, pos, n_valid):
    """(page, offset) of every K/V position a chunk launch writes live: a
    valid column whose (clipped) table entry is allocated."""
    out = set()
    for b in range(table.shape[0]):
        for j in range(n_valid[b]):
            p = pos[b] + j
            pid = table[b, min(p // STRIDE, T - 1)]
            if pid >= 0:
                out.add((int(pid), int(p % STRIDE)))
    return out


@pytest.mark.parametrize("name", sorted(JCONFIGS))
def test_chunk_step_drops_writes_where_jax_does(mesh16, plan16, name):
    """Two chunk launches through the JAX body and the port's.  The second
    has a full lane, a partial lane (padding columns), a lane whose chunk
    runs through an unallocated last entry and past its table (positions
    26..33 of a 32-position table), and an idle lane (table row -1, slot
    -1)."""
    jcfg = JCONFIGS[name]
    has_attn, has_dense = _kinds(jcfg)
    paged = PagedKV(n_blocks=B * T, block_pos_stride=STRIDE)
    body, in_specs, out_specs, specs, _ = make_prefill_chunk_body(
        jcfg, mesh16, plan16, batch=B, s_max=S_MAX, chunk=L, paged=paged,
        kernel_backend="jnp")
    jbody = jax.jit(jax.shard_map(body, mesh=mesh16, in_specs=in_specs,
                                  out_specs=out_specs, check_vma=False))
    params_d, tcfg, tparams, jarena, tarena = _setup(
        jcfg, mesh16, plan16, paged, N_SLOTS, specs)
    rng = np.random.default_rng(4)
    table = rng.permutation(B * T).astype(np.int32).reshape(B, T)
    table[2, T - 1] = -1
    table[3] = -1
    slots = np.array([2, 0, 4, -1], np.int32)
    put = lambda a, s: jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh16, s))
    t_ = torch.from_numpy
    jops = ([put(table, P(DATA, None))] if has_attn else []) \
        + ([put(slots, P(DATA))] if has_dense else [])
    tops = (t_(table) if has_attn else None, t_(slots) if has_dense else None)
    launches = [(np.zeros(B, np.int32), np.array([8, 5, 8, 0], np.int32)),
                (np.array([8, 5, 26, 0], np.int32),
                 np.array([8, 3, 8, 0], np.int32))]
    for second, (pos, n_valid) in enumerate(launches):
        snap = [{k: v.clone() for k, v in e.items()} for e in tarena]
        toks = rng.integers(0, jcfg.vocab_size, size=(B, L)).astype(np.int32)
        lj, jarena = jbody(params_d, jarena, put(toks, P(DATA, None)),
                           put(pos, P(DATA)), put(n_valid, P(DATA)), *jops)
        lt = prefill_chunk_step(tcfg, tparams, tarena, t_(toks), t_(pos),
                                t_(n_valid), *tops, stride=STRIDE)
        assert _rel(np.asarray(lj)[:3], lt.numpy()[:3]) < LOGIT_TOL
        live = _written(table, pos, n_valid) if has_attn else set()
        for posn, (mixer, _) in enumerate(jcfg.pattern()):
            te, before = tarena[posn], snap[posn]
            if mixer == "attn":
                je = _port_layout([jarena[posn]])[0]
                keep = torch.ones((B * T, STRIDE), dtype=torch.bool)
                for page, off in live:
                    keep[page, off] = False
                for leaf in ("k", "v"):
                    pool = te[leaf][:, :B * T]
                    assert _rel(je[leaf], pool.numpy()) < KV_TOL, leaf
                    assert torch.equal(pool[:, keep],
                                       before[leaf][:, :B * T][:, keep])
                    # padding, the idle lane and the unallocated entries
                    # wrote the scratch page
                    assert not torch.equal(te[leaf][:, B * T],
                                           before[leaf][:, B * T])
            else:
                je = _port_dense(jarena[posn], jcfg)
                for leaf in ("conv", "ssm"):
                    pool = te[leaf][:, :N_SLOTS]
                    assert _rel(je[leaf], pool.numpy()) < KV_TOL, leaf
                    for row in (1, 3):             # no lane holds them
                        assert torch.equal(pool[:, row],
                                           before[leaf][:, row])
                    # the idle lane wrote slot 0's state to the scratch
                    # row (zeros, as it was, at the first launch)
                    if second:
                        assert not torch.equal(te[leaf][:, N_SLOTS],
                                               before[leaf][:, N_SLOTS])


def _port_case(name):
    """A reduced port config, its params (seed 0) and an arena of random
    values (B * T pages, N_SLOTS slots, plus scratch)."""
    cfg = torch_config(HYBRID) if name == "hybrid" \
        else t_reduced(t_get_config(name))
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, generator=gen, device="cpu")
    specs = layer_state_specs(cfg, stride=STRIDE,
                              kvh=stored_heads(params, cfg)[1])
    arena = StateStore(specs, n_blocks=B * T, device=torch.device("cpu"),
                       n_slots=N_SLOTS, stride=STRIDE).arena
    for entry in arena:
        for leaf in entry.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return cfg, params, arena


PORT_CONFIGS = ["hybrid", "jamba-1.5-large-398b", "mamba2-780m",
                "qwen2-0.5b", "qwen3-moe-235b-a22b"]


def _call(kind, cfg, params, arena, tokens, pos, n_valid, table, slots):
    has_attn, has_dense = _kinds(cfg)
    ops = (table if has_attn else None, slots if has_dense else None)
    if kind == "decode":
        return decode_step(cfg, params, arena, tokens[:, 0], pos, *ops,
                           stride=STRIDE)
    return prefill_chunk_step(cfg, params, arena, tokens, pos, n_valid, *ops,
                              stride=STRIDE)


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_all_idle_step_writes_only_scratch(name, kind):
    cfg, params, arena = _port_case(name)
    before = [{k: v.clone() for k, v in e.items()} for e in arena]
    zeros = torch.zeros((B,), dtype=torch.int32)
    idle = torch.full((B,), -1, dtype=torch.int32)
    _call(kind, cfg, params, arena, torch.zeros((B, L), dtype=torch.int32),
          zeros, zeros, torch.full((B, T), -1, dtype=torch.int32), idle)
    for e, e0 in zip(arena, before):
        for leaf, a in e.items():
            assert torch.equal(a[:, :-1], e0[leaf][:, :-1]), leaf
            assert not torch.equal(a[:, -1], e0[leaf][:, -1]), leaf


class _NoHostSync(TorchDispatchMode):
    """Raises on an op that a CUDA graph capture refuses."""

    BANNED = (torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
              torch.ops.aten.lift_fresh)
    paused = 0          # inside a kernel's CPU-only plain version

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED and not self.paused:
            raise AssertionError(f"{func} in a step body")
        return func(*args, **(kwargs or {}))


def test_the_guard_catches_host_syncs():
    t = torch.tensor([0, 3, 0])
    for bad in (lambda: torch.nonzero(t), lambda: t[1].item(),
                lambda: bool(t[1]), lambda: torch.tensor([1, 2])):
        with pytest.raises(AssertionError):
            with _NoHostSync():
                bad()


@pytest.mark.parametrize("kind", ["decode", "chunk"])
@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_step_bodies_make_no_host_sync(name, kind, monkeypatch):
    """Live, partial and idle lanes; the second call runs under the
    guard."""
    cfg, params, arena = _port_case(name)
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L),
                                           dtype=np.int32))
    pos = torch.tensor([0, 4, 9, 0], dtype=torch.int32)
    n_valid = torch.tensor([8, 3, 1, 0], dtype=torch.int32)
    table = torch.from_numpy(rng.permutation(B * T).astype(np.int32)
                             .reshape(B, T))
    table[3] = -1
    slots = torch.tensor([1, 0, 2, -1], dtype=torch.int32)
    args = (kind, cfg, params, arena, tokens, pos, n_valid, table, slots)
    _call(*args)
    guard = _NoHostSync()
    plain_gmm = moe_mod.grouped_mm

    def gmm(x, w, offsets):
        assert x.device.type == "cpu"       # the card takes the kernel
        guard.paused += 1
        try:
            return plain_gmm(x, w, offsets)
        finally:
            guard.paused -= 1
    monkeypatch.setattr(moe_mod, "grouped_mm", gmm)
    with guard:
        logits = _call(*args)
    assert logits.shape[:2] == (B, 1) and logits.dtype == torch.float32
