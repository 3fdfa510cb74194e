"""repro_torch paged attention against both JAX backends.

On the CPU the port's ``paged_attention`` runs its plain version; it is
held against the JAX op under ``backend="pallas"`` (the TPU kernel, in
interpret mode) and ``backend="jnp"`` (the materialized gather), on
scrambled block tables with holes, GQA, one or two grid rows sharing the
physical page space and L in {1, 8}.  Per-row partials are compared after
the LSE row merge, at rel < 1e-5 (the bar the JAX package sets between its
own two backends).

The CUDA kernel against the plain version needs the card; it lives in
tests/test_torch_cuda.py, which imports no JAX.  What of the bf16 kernel
runs in Python is held here: its split planner, the LSE merge rule of its
splits (on the plain version), and the build's hashing of included
headers.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import merge_rows as j_merge_rows
from repro.kernels.paged_attention import paged_attention as j_paged_attention
from repro_torch.kernels.paged_attention import (merge_rows, paged_attention,
                                                 paged_attention_ref,
                                                 table_routing)
from repro_torch.kernels.paged_attention.kernel import (N_SM, split_count,
                                                        split_ranges,
                                                        tc_tile_l)

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


# ---------------------------------------------------------------------------
# The bf16 kernel's split over the block table.  Its planner and ranges are
# Python (the kernel takes n_split from the wrapper); its merge is the LSE
# rule, held here on the plain version: the plain partials of disjoint
# table ranges (entries outside a range set to -1), merged in split order,
# must give the unsplit plain result within 1e-6 relative in fp32.
# ---------------------------------------------------------------------------

SPLIT_TOL = 1e-6


@pytest.mark.parametrize("B", [1, 3, 8, 64, 200])
@pytest.mark.parametrize("T", [0, 1, 5, 32, 300])
def test_split_planner_fills_the_card_within_the_table(B, T):
    for (group, kvh), L in itertools.product(
            ((7, 2), (2, 8), (1, 4), (8, 1)), (1, 7, 16, 64, 256)):
        n_qt = -(-L // tc_tile_l(group, L))
        tiles = B * kvh * n_qt
        n = split_count(B, kvh, n_qt, T)
        assert 1 <= n <= max(T, 1)
        # about one block per SM where the table has the entries for it
        assert tiles * n >= min(N_SM, tiles * max(T, 1))
        if tiles >= N_SM:
            assert n == 1
        ranges = split_ranges(T, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == T
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c                      # disjoint, in table order
        assert all(0 <= a < b <= T for a, b in ranges) or T == 0


def test_split_planner_at_the_smoke_shapes():
    # qwen2-0.5b (14 q over 2 kv heads), s_max 512 / stride 16 -> T 32
    assert tc_tile_l(7, 1) == 1 and tc_tile_l(7, 256) == 16
    assert split_count(8, 2, 1, 32) * 16 >= N_SM       # batch-8 decode
    assert split_count(8, 2, 256 // 16, 32) == 1        # L 256: 256 tiles
    assert split_count(1, 2, 1, 64) == 64               # B 1, full table


def _lse_merge(parts):
    """The kernel's in-launch merge: max of m, then l and acc weighed by
    exp(m_s - m), summed in split order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for ms, ls, accs in parts:
        w = torch.exp(ms - m)
        l = l + ls * w
        acc = acc + accs * w[..., None]
    return m, l, acc


@pytest.mark.parametrize("n_split", [2, 3, 7])
@pytest.mark.parametrize("qrows", [1, 2])
@pytest.mark.parametrize("L", [1, 8])
def test_lse_merge_of_split_ranges_equals_unsplit(n_split, qrows, L):
    B, T, stride, kvh, hd, Hq = 3, 8, 4, 2, 8, 14
    rng = np.random.default_rng(100 * n_split + 10 * qrows + L)
    table, arenas, q, q_pos = _rand_case(rng, B=B, T=T, stride=stride,
                                         kvh=kvh, hd=hd, Hq=Hq, qrows=qrows,
                                         L=L)
    table[1, rng.integers(2, T)] = -1                 # more holes
    if qrows == 2:
        # slot 2: grid row 0's pages (even ids) all above q_pos, so that
        # row sees no visible key there; grid row 1 (odd ids) sees them
        ids = np.arange(B * T, dtype=np.int32)
        odd, even = ids[1::2][:T // 2], ids[0::2][:T // 2]
        table[2] = np.concatenate([odd, even])
        q_pos[2] = np.arange(L) + (T // 2 * stride - L)
    t = torch.from_numpy
    n_before = paged_attention_ref.launches
    whole, split = [], []
    for row, (kc, vc) in enumerate(arenas):
        args = (t(q), t(kc), t(vc))
        whole.append(paged_attention_ref(*args, t(table), t(q_pos),
                                         stride=stride, row=row,
                                         qrows=qrows))
        parts = []
        for a, b in split_ranges(T, n_split):
            cut = np.full_like(table, -1)
            cut[:, a:b] = table[:, a:b]
            parts.append(paged_attention_ref(*args, t(cut), t(q_pos),
                                             stride=stride, row=row,
                                             qrows=qrows))
        split.append(_lse_merge(parts))
        # the row maximum is exact; a row with a visible key agrees in l
        m_w, l_w, _ = whole[-1]
        m_s, l_s, _ = split[-1]
        assert torch.equal(m_w, m_s)
        seen = m_w > -1e29
        assert torch.allclose(l_w[seen], l_s[seen], rtol=SPLIT_TOL, atol=0)
        if qrows == 2 and row == 0:
            assert not seen[2].any()      # the all-masked rows are there
    assert paged_attention_ref.launches == n_before + qrows * (n_split + 1)
    want, got = merge_rows(whole), merge_rows(split)
    assert torch.isfinite(got).all()
    assert _rel(want.numpy(), got.numpy()) < SPLIT_TOL


def test_library_tag_follows_included_headers(tmp_path):
    from repro_torch.kernels.build import library_tag
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    hdr = tmp_path / "inc" / "tile.cuh"
    src.write_text('#include "inc/tile.cuh"\nint f() { return g(); }\n')
    hdr.write_text("inline int g() { return 1; }\n")
    tag = library_tag(src)
    assert library_tag(src) == tag                     # stable
    hdr.write_text("inline int g() { return 2; }\n")
    assert library_tag(src) != tag                     # header edited
    tag2 = library_tag(src)
    src.write_text('#include "inc/tile.cuh"\nint f() { return -g(); }\n')
    assert library_tag(src) not in (tag, tag2)         # source edited
