"""repro_torch paged attention against both JAX backends.

On the CPU the port's ``paged_attention`` runs its plain version; it is
held against the JAX op under ``backend="pallas"`` (the TPU kernel, in
interpret mode) and ``backend="jnp"`` (the materialized gather), on
scrambled block tables with holes, GQA, one or two grid rows sharing the
physical page space and L in {1, 8}.  Per-row partials are compared after
the LSE row merge, at rel < 1e-5 (the bar the JAX package sets between its
own two backends).

The CUDA kernel against the plain version needs the card; it lives in
tests/test_torch_cuda.py, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import merge_rows as j_merge_rows
from repro.kernels.paged_attention import paged_attention as j_paged_attention
from repro_torch.kernels.paged_attention import (merge_rows, paged_attention,
                                                 paged_attention_ref,
                                                 table_routing)

TOL = 1e-5


def _rand_case(rng, *, B, T, stride, kvh, hd, Hq, qrows, L, holes=True):
    n_blocks = B * T
    n_loc = -(-n_blocks // qrows)
    table = np.arange(n_blocks, dtype=np.int32)
    rng.shuffle(table)                       # pages are position-agnostic
    table = table.reshape(B, T)
    if holes:
        table[-1, -1] = -1                   # unallocated tail entry
        table[0, 1] = -1                     # and a hole mid-table
    arenas = [(rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32),
               rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32))
              for _ in range(qrows)]
    q = rng.normal(size=(B, Hq, L, hd)).astype(np.float32)
    pos = rng.integers(0, T * stride - L + 1, size=B).astype(np.int32)
    q_pos = pos[:, None] + np.arange(L, dtype=np.int32)[None]
    return table, arenas, q, q_pos


def _jax_merged(backend, table, arenas, q, q_pos, stride, qrows):
    parts = [j_paged_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table),
        jnp.asarray(q_pos), stride=stride, row=row, qrows=qrows,
        backend=backend, interpret=True)
        for row, (kc, vc) in enumerate(arenas)]
    return np.asarray(j_merge_rows(parts))


def _port_merged(table, arenas, q, q_pos, stride, qrows):
    t = torch.from_numpy
    parts = [paged_attention(t(q), t(kc), t(vc), t(table), t(q_pos),
                             stride=stride, row=row, qrows=qrows)
             for row, (kc, vc) in enumerate(arenas)]
    return merge_rows(parts).numpy()


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-9)


CASES = {
    # name: (seed, B, T, stride, kvh, hd, Hq)
    "gqa2": (10, 3, 4, 8, 2, 16, 4),
    "gqa7": (20, 2, 4, 4, 2, 8, 14),
}


@pytest.mark.parametrize("L", [1, 8], ids=["decode", "chunk"])
@pytest.mark.parametrize("qrows", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax_pallas_and_jnp(case, qrows, L):
    seed, B, T, stride, kvh, hd, Hq = CASES[case]
    rng = np.random.default_rng(seed + 2 * qrows + L)
    table, arenas, q, q_pos = _rand_case(
        rng, B=B, T=T, stride=stride, kvh=kvh, hd=hd, Hq=Hq, qrows=qrows,
        L=L)
    got = _port_merged(table, arenas, q, q_pos, stride, qrows)
    assert np.isfinite(got).all()
    for backend in ("pallas", "jnp"):
        want = _jax_merged(backend, table, arenas, q, q_pos, stride, qrows)
        assert _rel(want, got) < TOL, backend


def test_table_routing_matches_jax():
    from repro.kernels.paged_attention import table_routing as j_routing
    table = np.array([[5, -1, 2, 7], [0, 3, -1, 6]], np.int32)
    for qrows in (1, 2, 4):
        for row in range(qrows):
            jl, jo = j_routing(jnp.asarray(table), row, qrows)
            tl, to = table_routing(torch.from_numpy(table), row, qrows)
            assert (np.asarray(jl) == tl.numpy()).all()
            assert (np.asarray(jo) == to.numpy()).all()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    table, arenas, q, q_pos = _rand_case(
        rng, B=1, T=2, stride=4, kvh=2, hd=8, Hq=2, qrows=1, L=1)
    before = paged_attention_ref.launches
    t = torch.from_numpy
    paged_attention(t(q), t(arenas[0][0]), t(arenas[0][1]), t(table),
                    t(q_pos), stride=4)
    assert paged_attention_ref.launches == before + 1
