"""repro_torch's emulated SHMEM grid and Cannon GEMMs against the JAX ones.

The JAX side runs each program in ``shard_map`` over the 16-device
``mesh16`` (``repro.core``), one block per device; the port runs the same
program on the CPU over a ``(16, ...)`` stack of the same blocks, made with
numpy from a seed.  Tolerances:

  * grid ops move or sum small integers held in fp32: equal, bit for bit;
  * ``block_2d``/``unblock_2d``: equal, bit for bit;
  * fp32 GEMMs, per PE block, max abs difference over max abs value
    < 1e-5 (fp32 sums of the local products in another order than XLA's);
  * bf16 C-rotating Cannon: within one bf16 ulp of the JAX element (the
    accumulator is rounded to bf16 at every hop in both; an fp32 sum that
    differs in its last bits can round the other way);
  * the Cannon gradient: rel 1e-5, as the GEMMs.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core import cannon as jcannon
from repro.core.epiphany_model import table1_report as j_table1_report
from repro.core.hybrid import CommandQueue as JCommandQueue
from repro.core.hybrid import HybridKernel as JHybridKernel
from repro.core.shmem import ShmemGrid as JShmemGrid
from repro_torch.core import (CommandQueue, HybridKernel, ShmemGrid, cannon,
                              epiphany_model)
from repro_torch.kernels.cannon_mm import matmul_ref

JGRID = JShmemGrid("model", 4, 4)
GEMM_TOL = 1e-5


def _jax_run(mesh, body, *stacks):
    """``body(*blocks)`` per device over stacks sharded on dim 0; returns
    the (16, ...) stack of results (a tuple of stacks for a tuple)."""
    def wrapped(*args):
        out = body(*[a[0] for a in args])
        if isinstance(out, tuple):
            return tuple(o[None] for o in out)
        return out[None]

    f = jax.jit(jax.shard_map(wrapped, mesh=mesh,
                              in_specs=(P("model"),) * len(stacks),
                              out_specs=P("model"), check_vma=False))
    out = f(*[jnp.asarray(s) for s in stacks])
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _ints(seed, shape):
    """Small integers in fp32: every sum of them is exact."""
    return np.random.default_rng(seed).integers(-8, 9, shape) \
        .astype(np.float32)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


# ---------------------------------------------------------------------------
# ShmemGrid: every method against the JAX grid.
# ---------------------------------------------------------------------------

def test_shift_skew_and_transpose_match_jax(mesh16):
    x = _ints(0, (16, 3, 5))
    g = ShmemGrid(4, 4)
    pair_sets = [JGRID.skew_a_pairs(), JGRID.skew_b_pairs(),
                 JGRID.unskew_a_pairs(), JGRID.unskew_b_pairs(),
                 JGRID.transpose_pairs(), JGRID.row_shift_pairs(1),
                 JGRID.col_shift_pairs(-2)]
    ports = [g.skew_a_pairs(), g.skew_b_pairs(), g.unskew_a_pairs(),
             g.unskew_b_pairs(), g.transpose_pairs(), g.row_shift_pairs(1),
             g.col_shift_pairs(-2)]
    assert ports == pair_sets

    def body(b):
        a = JGRID.put(JGRID.put(b, JGRID.skew_a_pairs()),
                      JGRID.unskew_a_pairs())
        return (JGRID.put(b, JGRID.skew_a_pairs()),
                JGRID.put(b, JGRID.skew_b_pairs()),
                JGRID.put(b, JGRID.transpose_pairs()),
                JGRID.shift_rows(b, 1), JGRID.shift_cols(b, 3),
                JGRID.shift_rows(JGRID.shift_rows(b, 2), -2), a,
                JGRID.put(b, [(0, 5), (7, 2)]))     # partial: zeros elsewhere

    want = _jax_run(mesh16, body, x)
    t = torch.from_numpy(x)
    got = (g.put(t, g.skew_a_pairs()), g.put(t, g.skew_b_pairs()),
           g.put(t, g.transpose_pairs()), g.shift_rows(t, 1),
           g.shift_cols(t, 3), g.shift_rows(g.shift_rows(t, 2), -2),
           g.put(g.put(t, g.skew_a_pairs()), g.unskew_a_pairs()),
           g.put(t, [(0, 5), (7, 2)]))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o.numpy(), w)
    np.testing.assert_array_equal(got[6].numpy(), x)      # round trip
    # one put's wire bytes are one PE's block, as collective-permute's
    g2 = ShmemGrid(4, 4)
    g2.shift_cols(t)
    assert g2.comm_bytes == 3 * 5 * 4


def test_row_col_collectives_match_jax(mesh16):
    x = _ints(1, (16, 4, 6))

    def body(b):
        return (JGRID.psum_rows(b), JGRID.psum_cols(b), JGRID.pmax_cols(b),
                JGRID.pmax_cols_sg(b), JGRID.psum_all(b),
                JGRID.broadcast_from(b, 6), JGRID.barrier_all(b))

    want = _jax_run(mesh16, body, x)
    g = ShmemGrid(4, 4)
    t = torch.from_numpy(x)
    got = (g.psum_rows(t), g.psum_cols(t), g.pmax_cols(t),
           g.pmax_cols_sg(t), g.psum_all(t), g.broadcast_from(t, 6),
           g.barrier_all(t))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o.numpy(), w)
    assert g.barrier_all() is None and g.barrier_all(t, t) == (t, t)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather_matches_jax(mesh16, axis, tiled):
    x = _ints(2, (16, 2, 3))

    def body(b):
        return (JGRID.all_gather_rows(b, axis=axis, tiled=tiled),
                JGRID.all_gather_cols(b, axis=axis, tiled=tiled),
                JGRID.all_gather_flat(b, axis=axis, tiled=tiled))

    want = _jax_run(mesh16, body, x)
    g = ShmemGrid(4, 4)
    t = torch.from_numpy(x)
    got = (g.all_gather_rows(t, axis=axis, tiled=tiled),
           g.all_gather_cols(t, axis=axis, tiled=tiled),
           g.all_gather_flat(t, axis=axis, tiled=tiled))
    for w, o in zip(want, got):
        assert o.shape == w.shape
        np.testing.assert_array_equal(o.numpy(), w)


@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_scatter_and_all_to_all_match_jax(mesh16, axis):
    x = _ints(3, (16, 8, 4))

    def body(b):
        return (JGRID.reduce_scatter_rows(b, axis=axis),
                JGRID.reduce_scatter_cols(b, axis=axis),
                JGRID.all_to_all_rows(b, split_axis=axis,
                                      concat_axis=1 - axis),
                JGRID.all_to_all_rows(b, split_axis=0, concat_axis=0))

    want = _jax_run(mesh16, body, x)
    g = ShmemGrid(4, 4)
    t = torch.from_numpy(x)
    got = (g.reduce_scatter_rows(t, axis=axis),
           g.reduce_scatter_cols(t, axis=axis),
           g.all_to_all_rows(t, split_axis=axis, concat_axis=1 - axis),
           g.all_to_all_rows(t, split_axis=0, concat_axis=0))
    for w, o in zip(want, got):
        assert o.shape == w.shape
        np.testing.assert_array_equal(o.numpy(), w)


def test_one_pe_grid_is_the_identity():
    g = ShmemGrid(1, 1)
    t = torch.from_numpy(_ints(4, (1, 4, 4)))
    for out in (g.shift_rows(t), g.shift_cols(t, 3), g.psum_rows(t),
                g.psum_cols(t), g.psum_all(t), g.pmax_cols(t),
                g.all_gather_rows(t), g.all_gather_cols(t, axis=1),
                g.reduce_scatter_cols(t), g.put(t, g.transpose_pairs()),
                g.all_to_all_rows(t, 0, 1), g.broadcast_from(t, 0)):
        np.testing.assert_array_equal(out.numpy(), t.numpy())


# ---------------------------------------------------------------------------
# Storage modes and the GEMM strategies.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skew", [False, True, "crot"])
def test_block_2d_is_bit_identical_to_jax(skew):
    w = np.random.default_rng(5).standard_normal((32, 48)).astype(np.float32)
    want = np.array(jcannon.block_2d(jnp.asarray(w), 4, 4, skew_b=skew))
    got = cannon.block_2d(torch.from_numpy(w), 4, 4, skew_b=skew)
    np.testing.assert_array_equal(got.numpy(), want)
    back = cannon.unblock_2d(got, 4, 4, skew_b=skew)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcannon.unblock_2d(jnp.asarray(want), 4, 4,
                                                    skew_b=skew)))
    np.testing.assert_array_equal(back.numpy(), w)


STRATEGIES = {
    # name: (JAX fn, port fn, B storage mode, kwargs)
    "cannon": (jcannon.cannon_matmul, cannon.cannon_matmul, False, {}),
    "cannon_preskewed": (jcannon.cannon_matmul, cannon.cannon_matmul, True,
                         dict(preskewed_b=True)),
    "cannon_a_preskewed": (jcannon.cannon_matmul, cannon.cannon_matmul, True,
                           dict(preskewed_b=True, a_preskewed=True)),
    "crot": (jcannon.cannon_matmul_crot, cannon.cannon_matmul_crot, "crot",
             {}),
    "allgather": (jcannon.allgather_matmul, cannon.allgather_matmul, False,
                  {}),
    "summa": (jcannon.summa_matmul, cannon.summa_matmul, False, {}),
}


@pytest.mark.parametrize("mkn", [(64, 32, 48), (128, 128, 128), (32, 64, 16)])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_strategies_match_jax_per_pe_block(mesh16, mkn, strategy):
    M, K, N = mkn
    jfn, fn, skew, kw = STRATEGIES[strategy]
    rng = np.random.default_rng(sum(mkn))
    A = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    a_blocks = np.array(jcannon.block_2d(jnp.asarray(A), 4, 4))
    b_blocks = np.array(jcannon.block_2d(jnp.asarray(B), 4, 4, skew_b=skew))
    want = _jax_run(mesh16, lambda a, b: jfn(JGRID, a, b, **kw), a_blocks,
                    b_blocks)
    n0 = matmul_ref.launches
    got = fn(ShmemGrid(4, 4), torch.from_numpy(a_blocks),
             torch.from_numpy(b_blocks), **kw)
    # one local-product launch for all 16 PEs per round
    assert matmul_ref.launches - n0 == (1 if strategy == "allgather" else 4)
    assert got.shape == want.shape and got.dtype == torch.float32
    for pe in range(16):
        assert _rel(want[pe], got[pe].numpy()) < GEMM_TOL, pe


def test_crot_bf16_is_within_one_ulp_of_jax(mesh16):
    rng = np.random.default_rng(9)
    A = rng.standard_normal((64, 64)).astype(np.float32)
    B = rng.standard_normal((64, 96)).astype(np.float32)
    a_j = jcannon.block_2d(jnp.asarray(A, jnp.bfloat16), 4, 4)
    b_j = jcannon.block_2d(jnp.asarray(B, jnp.bfloat16), 4, 4, skew_b="crot")
    f = jax.jit(jax.shard_map(
        lambda a, b: jcannon.cannon_matmul_crot(JGRID, a[0], b[0])[None],
        mesh=mesh16, in_specs=(P("model"),) * 2, out_specs=P("model"),
        check_vma=False))
    want = np.asarray(f(a_j, b_j).astype(jnp.float32))
    a_t = torch.from_numpy(np.array(a_j.astype(jnp.float32))).bfloat16()
    b_t = torch.from_numpy(np.array(b_j.astype(jnp.float32))).bfloat16()
    got = cannon.cannon_matmul_crot(ShmemGrid(4, 4), a_t, b_t)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


def test_gemv2d_matches_jax(mesh16):
    rng = np.random.default_rng(1)
    K, N, M = 32, 48, 3
    x = rng.standard_normal((M, K)).astype(np.float32)
    B = rng.standard_normal((K, N)).astype(np.float32)
    x_blocks = np.stack([x[:, (p % 4) * 8:(p % 4 + 1) * 8] for p in range(16)])
    b_blocks = np.array(jcannon.block_2d(jnp.asarray(B), 4, 4))
    want = _jax_run(mesh16, lambda a, b: jcannon.gemv2d(JGRID, a, b),
                    x_blocks, b_blocks)
    got = cannon.gemv2d(ShmemGrid(4, 4), torch.from_numpy(x_blocks),
                        torch.from_numpy(b_blocks))
    for pe in range(16):
        assert _rel(want[pe], got[pe].numpy()) < GEMM_TOL


def test_skew_activation_round_trip_matches_jax(mesh16):
    x = _ints(6, (16, 4, 4))
    want = _jax_run(mesh16, lambda b: jcannon.skew_activation(JGRID, b), x)
    g = ShmemGrid(4, 4)
    got = cannon.skew_activation(g, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cannon.unskew_activation(g, got).numpy(), x)


def test_cannon_grad_matches_jax_grad(mesh16):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((32, 32)).astype(np.float32)
    B = rng.standard_normal((32, 32)).astype(np.float32)
    a_b = np.array(jcannon.block_2d(jnp.asarray(A), 4, 4))
    b_b = np.array(jcannon.block_2d(jnp.asarray(B), 4, 4, skew_b=True))

    def body(a, b):
        def loss(a_):
            return jnp.sum(jcannon.cannon_matmul(JGRID, a_, b,
                                                 preskewed_b=True) ** 2)
        return jax.grad(loss)(a)

    want = _jax_run(mesh16, body, a_b, b_b)
    a_t = torch.from_numpy(a_b).requires_grad_()
    b_t = torch.from_numpy(b_b).requires_grad_()
    out = cannon.cannon_matmul(ShmemGrid(4, 4), a_t, b_t, preskewed_b=True)
    (out ** 2).sum().backward()
    assert _rel(want, a_t.grad.numpy()) < GEMM_TOL
    # the dense gradients, assembled back: 2 (A B) B^T and 2 A^T (A B)
    gA = cannon.unblock_2d(a_t.grad, 4, 4).double().numpy()
    gB = cannon.unblock_2d(b_t.grad, 4, 4, skew_b=True).double().numpy()
    C = A.astype(np.float64) @ B
    assert _rel(2 * C @ B.T, gA) < GEMM_TOL
    assert _rel(2 * A.T.astype(np.float64) @ C, gB) < GEMM_TOL


# ---------------------------------------------------------------------------
# The paper's demonstration: Table 1 and the quickstart's two kernels.
# ---------------------------------------------------------------------------

def test_table1_report_equals_jax():
    assert epiphany_model.table1_report() == j_table1_report()


def test_quickstart_wire_bytes_equal_the_jax_queues(mesh16):
    """The port's per-PE wire bytes of the quickstart's two kernels at
    n = 256 equal what the JAX queue reads off the compiled HLO, and the
    FLOPs are 2 * (n/4)^3 per local product (XLA also counts the adds)."""
    n = 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    a_blocks = jcannon.block_2d(jnp.asarray(A), 4, 4)
    kernels = {
        "hybrid": (lambda g, a, b: jcannon.cannon_matmul(
            g, a[0], b[0], preskewed_b=True)[None],
            lambda g, a, b: cannon.cannon_matmul(g, a, b, preskewed_b=True),
            True, 4),
        "opencl": (lambda g, a, b: jcannon.allgather_matmul(
            g, a[0], b[0])[None], cannon.allgather_matmul, False, 1)}
    jq = JCommandQueue(mesh16)
    queue = CommandQueue("cpu")
    C = A.astype(np.float64) @ B
    for name, (jfn, fn, skew, n_products) in kernels.items():
        b_blocks = jcannon.block_2d(jnp.asarray(B), 4, 4, skew_b=skew)
        jk = JHybridKernel(jfn, grid=JGRID, in_specs=(P("model"),) * 2,
                           out_specs=P("model"), name=name)
        jq.build(jk, a_blocks, b_blocks)
        kern = HybridKernel(fn, grid=ShmemGrid(4, 4), name=name)
        blocks = [torch.from_numpy(np.array(x)) for x in (a_blocks, b_blocks)]
        out = queue.enqueue(kern, *blocks)
        queue.enqueue(kern, *blocks)
        queue.finish()
        ev = queue.events[name]
        assert ev.launches == 2
        assert ev.collective_bytes == jq.events[name].collective_bytes > 0
        k = n // 4 if name == "hybrid" else n
        assert ev.flops == n_products * 2 * (n // 4) ** 2 * k
        got = cannon.unblock_2d(out, 4, 4).double().numpy()
        assert _rel(C, got) < GEMM_TOL
    # the allgather baseline moves more bytes than Cannon with B pre-skewed
    assert queue.events["opencl"].collective_bytes \
        > queue.events["hybrid"].collective_bytes


def test_table1_launcher_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.table1", "--device", "cpu",
         "--sizes", "32", "64x32x48", "64:bfloat16"],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "n=  32" in out and "n= 128" in out and "fitted" in out

    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert [r["size"] for r in rows] == ["32", "64x32x48", "64:bfloat16"]
    for r in rows:
        tol = 1e-5 if r["dtype"] == "float32" else 1e-2
        assert r["hybrid_max_rel_err"] < tol and r["opencl_max_rel_err"] < tol
        assert r["hybrid_ms"] == r["opencl_ms"] == "not measured"
        assert r["bytes_ratio"] > 1.0
