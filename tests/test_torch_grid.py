"""The port's grid of PE processes against the JAX package's ShmemGrid.

Four CPU PE processes (``repro_torch.runtime.pe.run_pes``) run every
collective of ``PeGrid`` once over their shared-memory heaps
(``repro_torch.core.pe_grid.probe_collectives``); the same stacked numpy
inputs, made from a seed, go through ``repro.core.shmem.ShmemGrid`` under
``shard_map`` on a 2x2 grid of 4 of the host devices, and the flat
exchange through ``lax.all_to_all`` (``split_axis=0, concat_axis=0,
tiled=True``, as ``repro/models/moe.py:84`` calls it) in fp32, int8 and
int32.  Permutations and
gathers must match exactly; sums within fp32 rel 1e-6 (two-member sums in
fp32 are exact, so they match exactly too).  A PE that raises must end the
whole run, naming the PE, well inside the grid's timeout.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core.cannon import gemv2d as j_gemv2d
from repro.core.shmem import ShmemGrid
from repro.partition import DATA, MODEL
from repro.serve.decode import _rows_pmax
from repro_torch.core.pe_grid import PeGrid, probe_collectives
from repro_torch.partition import MeshPlan, grid_plan, parse_grid
from repro_torch.runtime.pe import PeFailed, fail_on, run_pes

Q = R = 2
EXACT = ("transpose", "shift_rows", "shift_cols", "pmax_rows",
         "all_gather_rows", "all_gather_cols", "broadcast_from",
         "all_to_all", "all_to_all_int8", "all_to_all_int32")
SUMS = ("psum_rows", "psum_cols", "reduce_scatter_rows", "gemv2d")


def _inputs():
    rng = np.random.default_rng(0)
    n = Q * R
    return {"x": rng.standard_normal((n, 4, 6)).astype(np.float32),
            "vec": rng.standard_normal((n, 3, 8)).astype(np.float32),
            "w": rng.standard_normal((n, 8, 5)).astype(np.float32)}


def _jax_results(inputs):
    mesh = jax.make_mesh((1, Q * R), (DATA, MODEL),
                         devices=jax.devices()[:Q * R],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    grid = ShmemGrid(MODEL, Q, R)

    def a2a(t):
        return jax.lax.all_to_all(t, MODEL, split_axis=0, concat_axis=0,
                                  tiled=True)

    def body(x, vec, w):
        x, vec, w = x[0], vec[0], w[0]
        out = {
            "all_to_all": a2a(x),
            "all_to_all_int8": a2a(jnp.clip(jnp.round(x * 40), -127, 127)
                                   .astype(jnp.int8)),
            "all_to_all_int32": a2a((x * 1000).astype(jnp.int32)),
            "transpose": grid.put(x, grid.transpose_pairs()),
            "shift_rows": grid.shift_rows(x, 1),
            "shift_cols": grid.shift_cols(x, 1),
            "psum_rows": grid.psum_rows(x),
            "psum_cols": grid.psum_cols(x),
            "pmax_rows": _rows_pmax(grid)(x),
            "all_gather_rows": grid.all_gather_rows(x, axis=0),
            "all_gather_cols": grid.all_gather_cols(x, axis=1),
            "reduce_scatter_rows": grid.reduce_scatter_rows(x, axis=0),
            "broadcast_from": grid.broadcast_from(x, 1),
            "gemv2d": j_gemv2d(grid, vec, w),
        }
        return {k: v[None] for k, v in out.items()}

    spec = P(MODEL)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                               out_specs=spec, check_vma=False))
    out = fn(jnp.asarray(inputs["x"]), jnp.asarray(inputs["vec"]),
             jnp.asarray(inputs["w"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def results():
    inputs = _inputs()
    port = run_pes(probe_collectives, grid_plan(Q, R), args=(inputs,),
                   device="cpu", timeout=60)
    return port, _jax_results(inputs)


@pytest.mark.parametrize("op", EXACT + SUMS)
def test_collective_matches_shmem_grid(results, op):
    port, want = results
    for pe in range(Q * R):
        got = port[pe][op]
        assert got.shape == want[op][pe].shape, (op, pe)
        if op in EXACT:
            np.testing.assert_array_equal(got, want[op][pe], err_msg=op)
        else:
            np.testing.assert_allclose(got, want[op][pe], rtol=1e-6,
                                       atol=1e-6, err_msg=op)


def test_failing_pe_is_named_inside_the_timeout():
    timeout = 30.0
    t0 = time.perf_counter()
    with pytest.raises(PeFailed) as err:
        run_pes(fail_on, grid_plan(Q, R), args=(3,), device="cpu",
                timeout=timeout)
    assert err.value.pe == 3
    assert "PE 3" in str(err.value) and "probe failure" in str(err.value)
    assert time.perf_counter() - t0 < timeout


def test_target_must_live_in_the_port():
    with pytest.raises(ValueError, match="repro_torch"):
        run_pes(_inputs, grid_plan(Q, R), device="cpu")


def test_one_pe_grid_is_the_identity():
    import torch
    g = PeGrid(0, 1, 1, device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert g.reserve(1 << 20) == 0 and g.heap is None
    for y in (g.put(x, g.transpose_pairs()), g.psum_rows(x), g.psum_cols(x),
              g.pmax_rows(x), g.all_gather_cols(x, axis=-1),
              g.reduce_scatter_rows(x), g.broadcast_from(x, 0)):
        assert y is x
    assert g.n_collectives == 0 and g.heap_bytes == 0


def test_plan():
    plan = parse_grid("2x2")
    assert (plan.grid_q, plan.grid_r, plan.n_pes) == (2, 2, 4)
    assert [plan.coords(p) for p in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert parse_grid("1x4") == grid_plan(1, 4)
    with pytest.raises(NotImplementedError, match="data_size"):
        MeshPlan((DATA, MODEL), (2, 4), 2, 2)
    with pytest.raises(ValueError):
        MeshPlan((DATA, MODEL), (1, 4), 2, 1)
