"""The port's CUDA kernels against their plain versions, on the card:
paged attention, the two SSD-scan passes and their fused launch, the
cannon_mm matmul (forward, backward, and one emulated Cannon call), flash
attention and the grouped GEMM of the MoE experts with its backward
(dgrad, wgrad, the autograd functions); the forward-only ops' refusal of
inputs that require grad; each library's first launch on a fresh
thread of a fresh process, equal to the main thread's; the symmetric
heap's put and reduce_slots, and every PeGrid collective on four PE
processes of the card against the same grid on the CPU.

Needs a CUDA card and nvcc; skips without a card.  The file imports no
JAX, so on a machine without it run it past the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: rel < 1e-5 with fp32 arenas, < 1e-3 with bf16 arenas (the
same bf16 inputs; products exact and sums in fp32 in both, another
summation order; the bf16 kernel scales the scores after the product and
carries its probabilities as two bf16 parts, about 2^-17 apart from fp32).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (merge_rows, paged_attention,
                                                 paged_attention_ref)


def _case(rng, *, B, T, stride, kvh, hd, Hq, qrows, L, mode="random"):
    """Block tables and positions.  mode "random": a scrambled table with a
    hole and an unallocated tail, positions anywhere; "full": every entry
    allocated, the last L positions of the table; "masked" (qrows 2): each
    slot's first half of entries on grid row 1, the second half on grid
    row 0, positions below all of row 0's labels; "causal0": a full table,
    the chunk from position 0."""
    n_blocks = B * T
    table = rng.permutation(n_blocks).astype(np.int32).reshape(B, T)
    if mode == "random":
        table[-1, -1] = -1                   # unallocated tail entry
        table[0, 1] = -1                     # a hole mid-table
    elif mode == "masked":
        h = T // 2
        odd, even = table[table % 2 == 1], table[table % 2 == 0]
        for b in range(B):
            table[b] = np.concatenate([odd[b * h:(b + 1) * h],
                                       even[b * h:(b + 1) * h]])
    n_loc = -(-n_blocks // qrows)
    arenas = [(rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32),
               rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32))
              for _ in range(qrows)]
    q = rng.normal(size=(B, Hq, L, hd)).astype(np.float32)
    pos = rng.integers(0, T * stride - L + 1, size=B).astype(np.int32)
    if mode == "full":
        pos[:] = T * stride - L
    elif mode == "masked":
        pos = rng.integers(0, T // 2 * stride - L + 1, size=B).astype(np.int32)
    elif mode == "causal0":
        pos[:] = 0
    return table, arenas, q, pos[:, None] + np.arange(L, dtype=np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [
    # B, T, stride, kvh, hd, Hq, L, qrows[, mode]
    (8, 32, 16, 2, 64, 14, 1, 1),        # qwen2-0.5b decode
    (8, 32, 16, 2, 64, 14, 5, 1),        # qwen2-0.5b verify, k = 4
    (1, 32, 16, 2, 64, 14, 5, 1, "full"),  # verify at a full table, B 1
    (2, 32, 16, 2, 64, 14, 256, 1),      # qwen2-0.5b prefill chunk
    (2, 8, 16, 8, 128, 16, 16, 1),       # hd 128, group 2
    (3, 4, 4, 4, 8, 8, 8, 2),            # reduced hd 8, two grid rows
    (2, 4, 8, 1, 32, 8, 3, 2),           # group 8, hd 32
    (2, 8, 8, 4, 16, 4, 5, 1),           # group 1, hd 16
    (8, 32, 16, 8, 160, 32, 1, 1),       # stablelm-12b decode, hd 160
    (2, 32, 16, 8, 160, 32, 64, 1),      # stablelm-12b chunk, hd 160
    (1, 32, 16, 8, 160, 32, 1, 1, "full"),  # hd 160 split decode
    (8, 32, 16, 4, 128, 28, 1, 1),       # qwen2-7b decode, group 7
    (2, 32, 16, 4, 128, 28, 256, 1),     # qwen2-7b chunk: 7 warps
    # the bf16 kernel's split over the table and its causal skip:
    (1, 64, 16, 2, 64, 14, 1, 1, "full"),     # 64 splits, every one busy
    (2, 32, 16, 2, 64, 14, 1, 2, "masked"),   # grid row 0 all masked
    (8, 32, 16, 2, 64, 14, 256, 1, "causal0"),  # one split, tiles skipped
    (2, 32, 16, 2, 64, 14, 256, 1, "causal0"),  # 3 splits and the skip
    (3, 16, 4, 2, 8, 8, 1, 1, "full"),        # hd 8 split decode
    (2, 16, 8, 4, 16, 8, 1, 1, "full"),       # hd 16 split decode
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(geometry, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, stride, kvh, hd, Hq, L, qrows, *mode = geometry
    mode = mode[0] if mode else "random"
    rng = np.random.default_rng(sum(geometry[:8]))
    table, arenas, q, q_pos = _case(rng, B=B, T=T, stride=stride, kvh=kvh,
                                    hd=hd, Hq=Hq, qrows=qrows, L=L, mode=mode)
    dev = lambda a, d=None: torch.from_numpy(a).to(device="cuda", dtype=d)
    ref, ker = [], []
    for row, (kc, vc) in enumerate(arenas):
        args = (dev(q, dtype), dev(kc, dtype), dev(vc, dtype), dev(table),
                dev(q_pos))
        ref.append(paged_attention_ref(*args, stride=stride, row=row,
                                       qrows=qrows))
        ker.append(paged_attention(*args, stride=stride, row=row,
                                   qrows=qrows))
    torch.cuda.synchronize()
    want, got = merge_rows(ref), merge_rows(ker)
    assert torch.isfinite(got).all()
    rel = float((want - got).abs().max() / want.abs().max())
    assert rel < (1e-5 if dtype == torch.float32 else 1e-3), rel
    if mode == "masked":
        # grid row 0 saw no visible key: m stays NEG_INF and l counts its
        # owned masked keys exactly, however the table was split
        m0, l0, _ = ker[0]
        owned = ((table >= 0) & (table % 2 == 0)).sum(1) * stride
        assert bool((m0 == -1e30).all())
        assert torch.equal(l0, torch.from_numpy(owned).to(l0)
                           [:, None, None].expand_as(l0))


@pytest.mark.gpu
def test_cuda_split_calls_repeat_bitwise():
    """Two calls on the same inputs give the same bits: the split merge runs
    in split order, and the per-tile counters are back at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda, split_count)
    rng = np.random.default_rng(9)
    table, arenas, q, q_pos = _case(rng, B=8, T=32, stride=16, kvh=2, hd=64,
                                    Hq=14, qrows=1, L=1, mode="full")
    assert split_count(8, 2, 1, 32) > 1
    dev = lambda a: torch.from_numpy(a).to("cuda", torch.bfloat16)
    args = (dev(q), dev(arenas[0][0]), dev(arenas[0][1]),
            torch.from_numpy(table).cuda(), torch.from_numpy(q_pos).cuda())
    first = paged_attention_cuda(*args, stride=16)
    for _ in range(3):
        again = paged_attention_cuda(*args, stride=16)
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    q = torch.zeros(1, 2, 1, 8, device="cuda")
    kc = torch.zeros(4, 4, 2, 8, device="cuda")
    table = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    q_pos = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged_attention_cuda(q.bfloat16(), kc, kc, table, q_pos, stride=4)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, kc, kc, table, q_pos, stride=8)
    with pytest.raises(ValueError):
        paged_attention_cuda(q, kc.cpu(), kc, table, q_pos, stride=4)
    kb = torch.zeros(kc.numel() + 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):                 # bf16 arena misaligned
        paged_attention_cuda(q.bfloat16(), kb[1:].view(kc.shape),
                             kc.bfloat16(), table, q_pos, stride=4)


# ---------------------------------------------------------------------------
# The two SSD-scan kernels against their plain versions.
#
# Tolerances, as max abs difference over max abs value: 1e-4 with fp32
# inputs (the kernels sum over s, n and the cumsum of dt * A in another
# order than torch: the decay exp(cum_t - cum_s) is a difference of two
# cumsums, whose rounding grows with |cum|); with bf16 inputs y_intra and y
# are rounded to bf16, so a last-bit flip is 2^-8 of an element: 1e-2.
# States and cumexp are fp32 in both cases: 1e-4.
# ---------------------------------------------------------------------------

def _ssd_case(rng, *, B, S, H, P, G, N, dtype, pad=0, init=True):
    x = rng.normal(size=(B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    if pad:
        dt[:, S - pad:] = 0.0                    # padding columns
    A = -np.exp(rng.uniform(np.log(0.5), np.log(8.0), size=H)) \
        .astype(np.float32)
    Bm = rng.normal(size=(B, S, G, N)).astype(np.float32) * 0.3
    Cm = rng.normal(size=(B, S, G, N)).astype(np.float32) * 0.3
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32) if init \
        else np.zeros((B, H, N, P), np.float32)
    cuda = lambda a, d=torch.float32: torch.from_numpy(a).to("cuda", d)
    return (cuda(x, dtype), cuda(dt), cuda(A), cuda(Bm, dtype),
            cuda(Cm, dtype), cuda(s0))


def _rel(want, got):
    want, got = want.double(), got.double()
    return float((want - got).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [
    # B, S, chunk, H, P, G, N, pad
    (8, 256, 256, 48, 64, 1, 128, 0),      # mamba2-780m, L = 256
    (2, 64, 64, 48, 64, 1, 128, 20),       # L = 64, padding columns
    (1, 16, 16, 48, 64, 1, 128, 5),        # L = 16
    (3, 1, 1, 48, 64, 1, 128, 0),          # L = 1
    (4, 5, 5, 8, 16, 1, 16, 1),            # reduced, L = 5: fp32 verify
    (2, 128, 64, 8, 16, 1, 16, 0),         # reduced, nc = 2
    (2, 96, 32, 8, 16, 4, 16, 7),          # reduced G = 4, nc = 3
    (1, 40, 40, 6, 8, 3, 8, 0),            # ragged L, P = 8
    (1, 70, 70, 4, 128, 2, 40, 0),         # P = 128, ragged N
    (1, 300, 300, 4, 32, 1, 160, 9),       # N > 128: bf16 on the CUDA cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_match_plain_versions(geometry, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_apply_ref, ssd_chunk_ref
    B, S, L, H, P, G, N, pad = geometry
    rng = np.random.default_rng(sum(geometry))
    x, dt, A, Bm, Cm, _ = _ssd_case(rng, B=B, S=S, H=H, P=P, G=G, N=N,
                                    dtype=dtype, pad=pad)
    want = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=L)
    got = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=L)
    torch.cuda.synchronize()
    y_tol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, w, g, tol in zip(("y_intra", "states", "cumexp"), want, got,
                               (y_tol, 1e-4, 1e-4)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(w, g) < tol, (name, _rel(w, g))
    nc = S // L
    states_in = torch.from_numpy(rng.normal(size=(B, nc, H, N, P)).astype(
        np.float32)).cuda()
    cr = Cm.reshape(B, nc, L, G, N)
    ya = ssd_apply_ref(want[0], cr, want[2], states_in)
    yb = ssd_apply_cuda(want[0], cr, want[2], states_in)
    torch.cuda.synchronize()
    assert yb.dtype == ya.dtype and _rel(ya, yb) < y_tol, _rel(ya, yb)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_on_the_card_matches_the_sequential_oracle(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_cuda
    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm, s0 = _ssd_case(rng, B=2, S=128, H=8, P=16, G=2, N=16,
                                     dtype=dtype, pad=9)
    before = ssd_chunk_cuda.launches
    y, final = ssd_scan(x, dt, A, Bm, Cm, s0, chunk=32)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm, s0)
    torch.cuda.synchronize()
    assert ssd_chunk_cuda.launches == before + 1
    assert _rel(fr, final) < 1e-4
    assert _rel(yr.float(), y.float()) < (1e-4 if dtype == torch.float32
                                          else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_read_packed_slices_in_place(dtype):
    """x, B and C as column slices of one packed (B, S, H*P + 2*G*N + 3)
    activation, as the mamba layer hands them over: the kernels read them
    through their row stride and give exactly the contiguous result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    B, S, L, H, P, G, N = 2, 64, 32, 8, 16, 2, 16
    rng = np.random.default_rng(11)
    _, dt, A, _, _, _ = _ssd_case(rng, B=B, S=S, H=H, P=P, G=G, N=N,
                                  dtype=dtype, pad=3)
    di, gn = H * P, G * N
    packed = torch.from_numpy(rng.normal(size=(B, S, di + 2 * gn + 3))
                              .astype(np.float32) * 0.4).to("cuda", dtype)
    x = packed[..., :di].reshape(B, S, H, P)
    Bm = packed[..., di:di + gn].reshape(B, S, G, N)
    Cm = packed[..., di + gn:di + 2 * gn].reshape(B, S, G, N)
    assert not x.is_contiguous() and not Cm.is_contiguous()
    got = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=L)
    want = ssd_chunk_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                          Cm.contiguous(), chunk=L)
    for name, w, g in zip(("y_intra", "states", "cumexp"), want, got):
        assert torch.equal(w, g), name
    nc = S // L
    states_in = torch.from_numpy(rng.normal(size=(B, nc, H, N, P)).astype(
        np.float32)).cuda()
    cr = Cm.reshape(B, nc, L, G, N)
    assert torch.equal(ssd_apply_cuda(want[0], cr, want[2], states_in),
                       ssd_apply_cuda(want[0], cr.contiguous(), want[2],
                                      states_in))
    with pytest.raises(ValueError):      # positions not evenly spaced
        ssd_chunk_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), dt,
                       A, Bm, Cm, chunk=L)


@pytest.mark.gpu
def test_ssd_wrappers_refuse_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda)
    rng = np.random.default_rng(0)
    x, dt, A, Bm, Cm, _ = _ssd_case(rng, B=1, S=16, H=4, P=16, G=2, N=8,
                                    dtype=torch.float32)
    with pytest.raises(TypeError):                  # x and B/C types differ
        ssd_chunk_cuda(x.bfloat16(), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError):                  # dt must be fp32
        ssd_chunk_cuda(x, dt.bfloat16(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError):                 # chunk does not divide S
        ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=5)
    with pytest.raises(ValueError):                 # an operand on the CPU
        ssd_chunk_cuda(x, dt.cpu(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError):                 # last dims not dense
        ssd_chunk_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                       A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError):                 # P = 12 not taken
        ssd_chunk_cuda(x[..., :12].contiguous(), dt, A, Bm, Cm, chunk=16)
    y, st, ce = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError):                 # states of another N
        ssd_apply_cuda(y, Cm.reshape(1, 1, 16, 2, 8), ce, st[..., :4, :]
                       .contiguous())
    with pytest.raises(TypeError):
        ssd_apply_cuda(y, Cm.reshape(1, 1, 16, 2, 8).bfloat16(), ce, st)


# The fused scan of one chunk (bf16, tensor cores) against its plain
# version at the tolerances above, and against the two passes it fuses:
# the same device code up to where each stores, so its y is within one bf16
# ulp of theirs and its final state within 1e-4.

def _bf16_ulps(want, got):
    """Largest |got - want| in units of want's bf16 ulp."""
    want, got = want.double(), got.double()
    e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
    return float(((got - want).abs() / 2.0 ** (e - 7)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [
    # B, S (= chunk), H, P, G, N, pad
    (8, 256, 48, 64, 1, 128, 0),           # mamba2-780m, L = 256
    (2, 64, 48, 64, 1, 128, 20),           # L = 64, padding columns
    (1, 16, 48, 64, 1, 128, 5),            # L = 16
    (3, 1, 48, 64, 1, 128, 0),             # L = 1
    (8, 5, 48, 64, 1, 128, 0),             # L = 5: verify at k = 4
    (1, 5, 48, 64, 1, 128, 2),             # L = 5, padding columns
    (2, 64, 8, 16, 4, 16, 7),              # reduced, G = 4
    (1, 40, 6, 8, 3, 8, 0),                # ragged L, P = 8
    (1, 70, 4, 128, 2, 40, 0),             # P = 128, ragged N
    (1, 300, 4, 32, 1, 96, 9),             # three row tiles
    (1, 1024, 2, 64, 1, 128, 0),           # the longest chunk
])
def test_ssd_fused_kernel_matches_plain_version(geometry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import _state_passing
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda,
                                                     ssd_scan_fused_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_fused_ref
    B, S, H, P, G, N, pad = geometry
    rng = np.random.default_rng(sum(geometry))
    x, dt, A, Bm, Cm, s0 = _ssd_case(rng, B=B, S=S, H=H, P=P, G=G, N=N,
                                     dtype=torch.bfloat16, pad=pad)
    y, fin = ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0, chunk=S)
    yr, fr = ssd_scan_fused_ref(x, dt, A, Bm, Cm, s0, chunk=S)
    torch.cuda.synchronize()
    assert y.shape == (B, S, H, P) and y.dtype == torch.bfloat16
    assert fin.shape == (B, H, N, P) and fin.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    assert _rel(yr, y) < 1e-2, _rel(yr, y)
    assert _rel(fr, fin) < 1e-4, _rel(fr, fin)
    yi, st, ce = ssd_chunk_cuda(x, dt, A, Bm, Cm, chunk=S)
    s_in, f2 = _state_passing(st, ce[:, :, -1, :], s0)
    y2 = ssd_apply_cuda(yi, Cm.reshape(B, 1, S, G, N), ce, s_in)
    torch.cuda.synchronize()
    assert _bf16_ulps(y2.reshape(y.shape), y) <= 1.0
    assert _rel(f2, fin) < 1e-4, _rel(f2, fin)


@pytest.mark.gpu
def test_ssd_fused_kernel_reads_packed_slices_in_place():
    """The engine's packed slices (16-byte aligned rows: cp.async staging)
    and a packed layout whose rows are not 16-byte aligned (scalar
    staging) give exactly what contiguous copies give."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan.kernel import plan, ssd_scan_fused_cuda
    B, S, H, P, G, N = 2, 64, 8, 64, 1, 128
    rng = np.random.default_rng(12)
    _, dt, A, _, _, s0 = _ssd_case(rng, B=B, S=S, H=H, P=P, G=G, N=N,
                                   dtype=torch.bfloat16, pad=5)
    di, gn = H * P, G * N
    for extra, staging in ((0, "async"), (3, "scalar")):
        packed = torch.from_numpy(rng.normal(size=(B, S, di + 2 * gn + extra))
                                  .astype(np.float32) * 0.4).to(
                                      "cuda", torch.bfloat16)
        x = packed[..., :di].reshape(B, S, H, P)
        Bm = packed[..., di:di + gn].reshape(B, S, G, N)
        Cm = packed[..., di + gn:di + 2 * gn].reshape(B, S, G, N)
        assert not x.is_contiguous()
        assert plan(x, Bm, Cm, chunk=S).staging == staging
        xc, bc, cc = x.contiguous(), Bm.contiguous(), Cm.contiguous()
        assert plan(xc, bc, cc, chunk=S).staging == "async"
        got = ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0, chunk=S)
        want = ssd_scan_fused_cuda(xc, dt, A, bc, cc, s0, chunk=S)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_ssd_fused_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fused_cuda
    rng = np.random.default_rng(1)
    x, dt, A, Bm, Cm, s0 = _ssd_case(rng, B=1, S=16, H=4, P=16, G=2, N=8,
                                     dtype=torch.bfloat16)
    with pytest.raises(TypeError):                  # fp32 takes two passes
        ssd_scan_fused_cuda(x.float(), dt, A, Bm.float(), Cm.float(), s0,
                            chunk=16)
    with pytest.raises(ValueError):                 # two chunks
        ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0, chunk=8)
    with pytest.raises(ValueError):                 # init of another N
        ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0[:, :, :4].contiguous(),
                            chunk=16)
    with pytest.raises(ValueError):                 # init not fp32
        ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0.bfloat16(), chunk=16)
    with pytest.raises(ValueError):                 # init on the CPU
        ssd_scan_fused_cuda(x, dt, A, Bm, Cm, s0.cpu(), chunk=16)
    with pytest.raises(ValueError):                 # N > 128: two passes
        big = torch.zeros((1, 16, 2, 136), dtype=torch.bfloat16,
                          device="cuda")
        ssd_scan_fused_cuda(x, dt, A, big, big,
                            torch.zeros((1, 4, 136, 16), device="cuda"),
                            chunk=16)


@pytest.mark.gpu
def test_ssd_scan_launch_counts_follow_plan():
    """ssd_scan on the card: one fused launch for bf16 at one chunk, the
    two passes for fp32 or several chunks, and never a plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import (ssd_apply_cuda,
                                                     ssd_chunk_cuda,
                                                     ssd_scan_fused_cuda)
    from repro_torch.kernels.ssd_scan.ref import (ssd_apply_ref,
                                                  ssd_chunk_ref,
                                                  ssd_scan_fused_ref)
    kerns = (ssd_scan_fused_cuda, ssd_chunk_cuda, ssd_apply_cuda)
    plains = (ssd_scan_fused_ref, ssd_chunk_ref, ssd_apply_ref)
    rng = np.random.default_rng(2)
    for dtype, chunk, want in ((torch.bfloat16, 32, (1, 0, 0)),
                               (torch.bfloat16, 8, (0, 1, 1)),
                               (torch.float32, 32, (0, 1, 1))):
        ops = _ssd_case(rng, B=2, S=32, H=8, P=16, G=2, N=16, dtype=dtype,
                        pad=3)
        n0 = [k.launches for k in kerns]
        p0 = [p.launches for p in plains]
        ssd_scan(*ops, chunk=chunk)
        assert tuple(k.launches - n for k, n in zip(kerns, n0)) == want
        assert [p.launches for p in plains] == p0


# ---------------------------------------------------------------------------
# The cannon_mm matmul and flash attention against their plain versions.
#
# Tolerance, as max abs difference over max abs value of the plain output
# (tests/test_kernels.py's): 2e-4 with fp32 operands (fp32 FMAs, never
# TF32, summed over K in another order), 3e-2 with bf16 (exact products,
# fp32 sums, one rounding of the output to bf16).
# ---------------------------------------------------------------------------

MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _mm_operands(rng, P, M, K, N, dtype):
    a = torch.from_numpy(rng.normal(size=(P, M, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(P, K, N)).astype(np.float32))
    return a.to("cuda", dtype), b.to("cuda", dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("pmkn", [
    (1, 256, 256, 256), (1, 512, 256, 384), (1, 128, 512, 128),
    (1, 100, 37, 130),                      # ragged, rows not 16-byte aligned
    (1, 100, 64, 136),                      # ragged, rows 16-byte aligned
    (16, 64, 48, 80),                       # one Cannon round of 16 PEs
    # K not a multiple of 64 (wgmma) or 16 (f32_vec), M and N not
    # multiples of any tile, rows 16-byte aligned: the fast variants
    (1, 200, 200, 328), (16, 136, 104, 264),
    (16, 1024, 224, 1216),                  # the bf16 Cannon round's block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_kernel_matches_plain_version(pmkn, dtype, out_dtype):
    """Every variant of the family, as plan() routes these layouts; the
    per-variant counts move as plan() said."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda, plan
    P, M, K, N = pmkn
    a, b = _mm_operands(np.random.default_rng(sum(pmkn)), P, M, K, N, dtype)
    if P == 1:
        a, b = a[0], b[0]
    before = dict(matmul_cuda.by_variant)
    got = blocked_matmul(a, b, out_dtype=out_dtype)
    want = matmul_ref(a, b, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(want, got) < MM_TOL[dtype]
    # transposed operands are read through their strides, not copied
    at, bt = b.transpose(-1, -2), a.transpose(-1, -2)
    got_t = blocked_matmul(at, bt, out_dtype=out_dtype)
    want_t = matmul_ref(at, bt, out_dtype)
    assert _rel(want_t, got_t) < MM_TOL[dtype]
    moved = {k: n - before[k] for k, n in matmul_cuda.by_variant.items()}
    expect = dict.fromkeys(moved, 0)
    for x, y in ((a, b), (at, bt)):
        expect[plan(x, y).variant] += 1
    assert moved == expect


@pytest.mark.gpu
@pytest.mark.parametrize("pmkn", [(1, 200, 200, 328), (16, 136, 104, 264),
                                  (1, 100, 37, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_calls_repeat_bitwise(pmkn, dtype):
    """No variant uses atomics: two calls give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    a, b = _mm_operands(np.random.default_rng(11), *pmkn, dtype)
    one = matmul_cuda(a, b, out_dtype=torch.float32)
    two = matmul_cuda(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_backward_matches_autograd_of_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    a, b = _mm_operands(np.random.default_rng(7), 16, 48, 64, 40, dtype)
    g = torch.from_numpy(np.random.default_rng(8).normal(
        size=(16, 48, 40)).astype(np.float32)).cuda()
    grads = []
    for fn in (matmul_ref, blocked_matmul):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        n0 = matmul_cuda.launches
        out = fn(x, y, out_dtype=torch.float32) if fn is blocked_matmul \
            else fn(x, y, torch.float32)
        out.backward(g)
        grads.append((x.grad, y.grad, matmul_cuda.launches - n0))
    torch.cuda.synchronize()
    (ga0, gb0, _), (ga1, gb1, n) = grads
    assert n == 3                   # forward, dA and dB: the same kernel
    assert ga1.dtype == dtype and gb1.dtype == dtype
    assert _rel(ga0, ga1) < MM_TOL[dtype] and _rel(gb0, gb1) < MM_TOL[dtype]


@pytest.mark.gpu
def test_matmul_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    a = torch.zeros(8, 4, device="cuda")
    b = torch.zeros(4, 6, device="cuda")
    with pytest.raises(TypeError):                  # mixed dtypes
        matmul_cuda(a, b.bfloat16())
    with pytest.raises(TypeError):                  # fp16 output
        matmul_cuda(a, b, out_dtype=torch.float16)
    with pytest.raises(ValueError):                 # K does not chain
        matmul_cuda(a, b[:3])
    with pytest.raises(ValueError):                 # rank mismatch
        matmul_cuda(a[None], b)
    with pytest.raises(ValueError):                 # an operand on the CPU
        matmul_cuda(a, b.cpu())


@pytest.mark.gpu
def test_matmul_launcher_refuses_a_variant_the_layout_does_not_allow(
        monkeypatch):
    """The C launcher checks the planned variant against dtypes and layout:
    a wrong plan is refused (the wrapper raises), never run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm import kernel
    a = torch.zeros(100, 37, device="cuda")
    b = torch.zeros(37, 130, device="cuda")
    real = kernel.plan(a, b)
    assert real.variant == "f32_general"
    for wrong in ("f32_vec", "mma_general", "wgmma_tma"):
        monkeypatch.setattr(kernel, "plan", lambda *_, w=wrong: real._replace(
            variant=w, layout=0))
        n = kernel.matmul_cuda.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            kernel.matmul_cuda(a, b)
        assert kernel.matmul_cuda.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["cannon", "preskewed", "crot",
                                      "allgather", "summa"])
def test_emulated_cannon_on_the_card_matches_the_plain_run(strategy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import ShmemGrid, block_2d, cannon
    from repro_torch.kernels.cannon_mm import matmul_ref
    from repro_torch.kernels.cannon_mm.kernel import matmul_cuda
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.normal(size=(128, 96)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(96, 64)).astype(np.float32))
    skew = {"preskewed": True, "crot": "crot"}.get(strategy, False)
    fn = {"cannon": cannon.cannon_matmul, "preskewed": cannon.cannon_matmul,
          "crot": cannon.cannon_matmul_crot,
          "allgather": cannon.allgather_matmul,
          "summa": cannon.summa_matmul}[strategy]
    kw = dict(preskewed_b=True) if strategy == "preskewed" else {}
    n = 1 if strategy == "allgather" else 4       # launches per call
    outs = []
    for dev in ("cpu", "cuda"):
        a, b = block_2d(A.to(dev), 4, 4), block_2d(B.to(dev), 4, 4, skew)
        n_ker, n_ref = matmul_cuda.launches, matmul_ref.launches
        outs.append(fn(ShmemGrid(4, 4), a, b, **kw).cpu())
        ran = (matmul_cuda.launches - n_ker, matmul_ref.launches - n_ref)
        assert ran == ((0, n) if dev == "cpu" else (n, 0)), ran
    assert _rel(outs[0], outs[1]) < 2e-4


# Flash attention is held twice: against the output's scale (FLASH_TOL,
# as tests/test_kernels.py) and elementwise, so that every row answers for
# its own magnitude: fp32 within 2e-5 absolute; bf16 within one bf16 ulp of
# the plain element plus 1e-5 (both compute in fp32 and round once to bf16;
# the 1e-5 covers outputs near zero, where fp32's own rounding is several
# bf16 ulps).
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-5}


def _flash_within_elementwise(want, got):
    d = (want.double() - got.double()).abs()
    lim = torch.full_like(d, FLASH_ATOL[got.dtype])
    if got.dtype == torch.bfloat16:
        w = want.double().abs().clamp_min(2.0 ** -126)
        lim += torch.exp2(torch.floor(torch.log2(w)) - 7)
    return bool((d <= lim).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Skv, D, q_offset): tests/test_kernels.py's, then
    # ragged tails and an offset block of a longer sequence
    (2, 4, 2, 256, 256, 64, 0),
    (1, 8, 8, 128, 512, 32, 384),
    (2, 4, 1, 128, 128, 128, 0),
    (1, 2, 2, 384, 384, 64, 0),
    (2, 14, 2, 100, 100, 64, 0),
    (1, 16, 8, 77, 301, 128, 224),
    # qwen2-0.5b and qwen3-0.6b prefill geometry
    (1, 14, 2, 1024, 1024, 64, 0),
    (1, 16, 8, 1024, 1024, 128, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(shape, dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    B, Hq, Hkv, Sq, Skv, D, off = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to("cuda", dtype) for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                                            (B, Hkv, Skv, D)))
    got = flash_attention(q, k, v, causal=causal, q_offset=off)
    want = attention_ref(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert _rel(want, got) < FLASH_TOL[dtype]
    assert _flash_within_elementwise(want, got)


@pytest.mark.gpu
def test_flash_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    q = torch.zeros(1, 4, 16, 64, device="cuda")
    k = torch.zeros(1, 2, 16, 64, device="cuda")
    with pytest.raises(TypeError):                  # q and k types differ
        flash_attention_cuda(q, k.bfloat16(), k)
    with pytest.raises(ValueError):                 # D = 48 not taken
        flash_attention_cuda(q[..., :48].contiguous(),
                             k[..., :48].contiguous(), k[..., :48]
                             .contiguous())
    with pytest.raises(ValueError):                 # 3 kv heads into 4
        flash_attention_cuda(q, k.repeat(1, 2, 1, 1)[:, :3].contiguous(),
                             k.repeat(1, 2, 1, 1)[:, :3].contiguous())
    with pytest.raises(ValueError):                 # not contiguous
        flash_attention_cuda(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError):                 # negative offset
        flash_attention_cuda(q, k, k, q_offset=-1)
    with pytest.raises(ValueError):                 # an operand on the CPU
        flash_attention_cuda(q, k.cpu(), k)


# ---------------------------------------------------------------------------
# Steps captured as CUDA graphs (CommandQueue.build): a replay against the
# eager body on a copy of the same arena with the same operands, bit for
# bit (the same kernels on the same inputs; the scratch page and row, where
# duplicate dropped writes land in no fixed order, are left out).
# ---------------------------------------------------------------------------

STEP_B, STEP_STRIDE, STEP_T, STEP_SLOTS = 4, 16, 32, 6


def _step_case(name, dtype):
    """A reduced config in ``dtype``, its params (seed 0), an arena of
    random values on the card, and host operands at the engine's widths:
    a full lane, a partial one, a one-token rider and an idle lane."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.params import init_params, stored_heads
    from repro_torch.serve.engine.state_store import StateStore
    from repro_torch.serve.state import layer_state_specs
    cfg = dataclasses.replace(reduced(get_config(name)), param_dtype=dtype,
                              compute_dtype=dtype)
    gen = torch.Generator("cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, device="cuda")
    specs = layer_state_specs(cfg, stride=STEP_STRIDE,
                              kvh=stored_heads(params, cfg)[1])
    arena = StateStore(specs, n_blocks=STEP_B * STEP_T,
                       device=torch.device("cuda"), n_slots=STEP_SLOTS,
                       stride=STEP_STRIDE).arena
    for entry in arena:
        for leaf in entry.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda"))
    rng = np.random.default_rng(3)
    table = rng.permutation(STEP_B * STEP_T).astype(np.int32).reshape(
        STEP_B, STEP_T)
    table[3] = -1
    ops = dict(pos=np.array([0, 17, 100, 0], np.int32),
               table=table if specs.has_paged else None,
               slots=np.array([1, 0, 2, -1], np.int32)
               if specs.has_dense else None)
    return cfg, params, arena, ops, rng


def _step_operands(cfg, ops, rng, L, idle=False):
    """Pinned host operands of a decode step (L = 0) or a chunk step."""
    B = STEP_B
    shape = (B,) if L == 0 else (B, L)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
           "pos": ops["pos"]}
    if L:
        out["n_valid"] = np.array([L, L // 2, 1, 0], np.int32)
    out["table"], out["slots"] = ops["table"], ops["slots"]
    if idle:
        out = {k: None if a is None else np.full_like(
            a, -1 if k in ("table", "slots") else 0) for k, a in out.items()}
    return tuple(None if a is None else torch.from_numpy(a).pin_memory()
                 for a in out.values())


def _max_diff(a, b):
    return float((a.double() - b.double()).abs().max())


def _replay_against_eager(name, dtype, L, all_logits=False):
    """Build with every lane idle (as the engine does), replay once for
    real operands: logits (every row) and the arena's pool equal the eager
    body's, and the kernels' counts move by what the eager body
    launches."""
    import functools
    from repro_torch.core import CommandQueue
    from repro_torch.kernels import count_delta, launch_counts
    from repro_torch.serve.decode import decode_step, prefill_chunk_step
    cfg, params, arena, ops, rng = _step_case(name, dtype)
    twin = [{k: v.clone() for k, v in e.items()} for e in arena]
    body = functools.partial(decode_step, cfg, stride=STEP_STRIDE) \
        if L == 0 else functools.partial(prefill_chunk_step, cfg,
                                         stride=STEP_STRIDE,
                                         all_logits=all_logits)
    queue = CommandQueue("cuda")
    c0 = launch_counts()
    queue.build("step", body, params, arena,
                *_step_operands(cfg, ops, rng, L, idle=True))
    assert count_delta(c0, launch_counts()) == {}  # building is no launch
    args = _step_operands(cfg, ops, rng, L)
    c0 = launch_counts()
    got = queue.enqueue("step", body, params, arena, *args).clone()
    replayed = count_delta(c0, launch_counts())
    c0 = launch_counts()
    want = body(params, twin, *(None if a is None else a.cuda()
                                for a in args))
    eager = count_delta(c0, launch_counts())
    torch.cuda.synchronize()
    assert replayed == eager
    assert torch.equal(got, want), _max_diff(got, want)
    assert got.shape[1] == (L if all_logits else 1)
    for e, e0 in zip(arena, twin):
        for leaf, a in e.items():
            assert torch.equal(a[:, :-1], e0[leaf][:, :-1]), \
                (leaf, _max_diff(a[:, :-1], e0[leaf][:, :-1]))


STEP_MODELS = ["qwen2-0.5b", "mamba2-780m", "qwen3-moe-235b-a22b",
               "jamba-1.5-large-398b"]


@pytest.mark.gpu
@pytest.mark.parametrize("L", [0, 16, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", STEP_MODELS)
def test_replayed_step_matches_eager_body(name, dtype, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _replay_against_eager(name, dtype, L)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", STEP_MODELS)
def test_replayed_verify_step_matches_eager_body(name, dtype):
    """The speculative ``verify_bs{N}_len5`` step (k = 4: every position's
    logits) replayed against its eager body, all rows compared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _replay_against_eager(name, dtype, 5, all_logits=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_bodies_make_no_sync_on_the_card(name):
    """After one call outside it, a decode and a chunk step run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve.decode import decode_step, prefill_chunk_step
    cfg, params, arena, ops, rng = _step_case(name, torch.bfloat16)
    for L, body in ((0, decode_step), (16, prefill_chunk_step)):
        args = [None if a is None else a.cuda()
                for a in _step_operands(cfg, ops, rng, L)]
        body(cfg, params, arena, *args, stride=STEP_STRIDE)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            body(cfg, params, arena, *args, stride=STEP_STRIDE)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_bf16_logits_keep_fp32_sums():
    """The card's lm_head product (bf16 in, fp32 out, ``aten::mm.dtype``)
    against the fp32 product of the same bf16 values, at qwen2-0.5b's
    width: the products are exact in fp32 and only the summation order
    differs (rel < 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve.decode import _last_logits
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(8, 1, 896, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(896, 151936, generator=gen, device="cuda")
         * 896 ** -0.5).bfloat16()
    got = _last_logits(w, x)
    want = torch.matmul(x.float(), w.float())
    assert got.dtype == torch.float32 and got.shape == (8, 1, 151936)
    assert _rel(want, got) < 1e-5


# ---------------------------------------------------------------------------
# The grouped GEMM (MoE experts): bf16 on the tensor cores (mma variant at
# few rows an expert, wgmma_tma at many), fp32 on the CUDA cores (simt),
# each also with the silu x up epilogue.  The kernel and its plain version
# both sum in fp32 and round once; where the two sums straddle a rounding
# boundary bf16 outputs differ by one ulp (at most 2^-7 of the value), fp32
# ones by the summation order (rel < 1e-5).  The epilogue rounds the sums,
# the silu and the product where the plain version does, so a one-ulp
# difference of a sum moves its output by about one ulp: the same bound.
# ---------------------------------------------------------------------------

GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # M, K, N, E, group sizes, rows before offsets[0]
    (64, 4096, 3072, 128, "top8", 0),       # qwen3-moe w1, batch-8 decode
    (320, 1536, 4096, 128, "top8", 0),      # qwen3-moe w2, verify k = 4
    (1024, 256, 384, 16, "top8", 0),        # several M tiles an expert
    (77, 64, 64, 16, [0, 9, 0, 0, 30, 0, 0, 1, 0, 0, 0, 17, 0, 0, 20, 0], 0),
    (300, 64, 136, 16, [0] * 5 + [300] + [0] * 10, 0),
    (100, 40, 72, 6, [13, 0, 25, 2, 0, 30], 0),   # rows past offsets[E]
    (90, 32, 64, 4, [20, 0, 31, 9], 11),          # and before offsets[0]
    (33, 32, 64, 8, [0] * 8, 5),                  # no expert has a row
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import grouped_mm, grouped_mm_ref
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_cuda, plan
    M, K, N, E, sizes, head = case
    rng = np.random.default_rng(M)
    if sizes == "top8":
        picks = np.argsort(rng.random((M // 8, E)), axis=1)[:, :8]
        sizes = np.bincount(picks.ravel(), minlength=E)
    offsets = torch.from_numpy((head + np.concatenate(
        [[0], np.cumsum(sizes)])).astype(np.int32)).cuda()
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        "cuda", dtype)
    w = (torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32))
         * K ** -0.5).to("cuda", dtype)
    variant = plan(x, w)
    n0, v0 = grouped_mm_cuda.launches, grouped_mm_cuda.by_variant[variant]
    got = grouped_mm(x, w, offsets)
    assert grouped_mm_cuda.launches == n0 + 1
    assert grouped_mm_cuda.by_variant[variant] == v0 + 1
    want = grouped_mm_ref(x, w, offsets)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    assert _rel(want, got) <= GMM_TOL[dtype]
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not got[:lo].any() and not got[hi:].any()


def _gmm_case(case, dtype, seed):
    """x, w, offsets on the card for (M, K, N, E, group sizes or "top8",
    rows before offsets[0])."""
    M, K, N, E, sizes, head = case
    rng = np.random.default_rng(seed)
    if sizes == "top8":
        picks = np.argsort(rng.random((M // 8, E)), axis=1)[:, :8]
        sizes = np.bincount(picks.ravel(), minlength=E)
    offsets = torch.from_numpy((head + np.concatenate(
        [[0], np.cumsum(sizes)])).astype(np.int32)).cuda()
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        "cuda", dtype)
    w = (torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32))
         * K ** -0.5).to("cuda", dtype)
    return x, w, offsets


GMM_VARIANT_CASES = [
    # M, K, N, E, group sizes, rows before offsets[0]; N a multiple of 16
    (8192, 512, 1024, 64, "top8", 0),       # 128 rows an expert (len256)
    (2048, 512, 768, 64, "top8", 0),        # 32 rows an expert (len64)
    (1024, 256, 384, 16, "top8", 0),        # several row tiles an expert
    (77, 64, 64, 16, [0, 9, 0, 0, 30, 0, 0, 1, 0, 0, 0, 17, 0, 0, 20, 0], 0),
    (300, 64, 144, 16, [0] * 5 + [300] + [0] * 10, 0),
    (100, 40, 80, 6, [13, 0, 25, 2, 0, 30], 0),   # K and N ragged, past [E]
    (90, 32, 64, 4, [20, 0, 31, 9], 11),          # and before offsets[0]
    (33, 32, 64, 8, [0] * 8, 5),                  # no expert has a row
    # one expert holds 600 rows (three row groups, its strip read three
    # times), ragged N tiles (208: 128 + 80, or 64 + 40 output columns)
    (720, 96, 208, 5, [40, 600, 0, 7, 13], 45),
]


@pytest.mark.gpu
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("variant", ["mma", "wgmma_tma"])
@pytest.mark.parametrize("case", GMM_VARIANT_CASES)
def test_grouped_mm_bf16_variants_match_plain_version(case, variant, swiglu):
    """Each bf16 variant, forced whatever plan would pick, with and without
    the silu x up epilogue, against the plain version of its function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda)
    x, w, offsets = _gmm_case(case, torch.bfloat16, seed=case[0])
    kern = grouped_mm_swiglu_cuda if swiglu else grouped_mm_cuda
    ref = grouped_mm_swiglu_ref if swiglu else grouped_mm_ref
    n0, v0 = kern.launches, kern.by_variant[variant]
    got = kern(x, w, offsets, variant=variant)
    assert kern.launches == n0 + 1 and kern.by_variant[variant] == v0 + 1
    want = ref(x, w, offsets)
    torch.cuda.synchronize()
    M, N = case[0], case[2]
    assert got.shape == (M, N // 2 if swiglu else N)
    assert torch.isfinite(got).all()
    assert _rel(want, got) <= GMM_TOL[torch.bfloat16]
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not got[:lo].any() and not got[hi:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (64, 4096, 3072, 128, "top8", 0),
    (100, 40, 80, 6, [13, 0, 25, 2, 0, 30], 0),
    (90, 37, 70, 4, [20, 0, 31, 9], 11),          # any even N
])
def test_grouped_mm_swiglu_fp32_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import (grouped_mm_swiglu,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_swiglu_cuda
    x, w, offsets = _gmm_case(case, torch.float32, seed=7)
    n0 = grouped_mm_swiglu_cuda.by_variant["simt"]
    got = grouped_mm_swiglu(x, w, offsets)
    assert grouped_mm_swiglu_cuda.by_variant["simt"] == n0 + 1
    want = grouped_mm_swiglu_ref(x, w, offsets)
    torch.cuda.synchronize()
    assert got.shape == (case[0], case[2] // 2)
    assert _rel(want, got) <= GMM_TOL[torch.float32]
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not got[:lo].any() and not got[hi:].any()


@pytest.mark.gpu
def test_grouped_mm_fp32_takes_any_k_and_n():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import grouped_mm_ref
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_cuda
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(53, 37, generator=gen, device="cuda")
    w = torch.randn(4, 37, 70, generator=gen, device="cuda")
    off = torch.tensor([0, 7, 7, 31, 50], dtype=torch.int32, device="cuda")
    assert _rel(grouped_mm_ref(x, w, off), grouped_mm_cuda(x, w, off)) \
        <= GMM_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_replays_with_new_offsets(dtype):
    """Captured once in a CUDA graph, the launch reads the offsets on the
    card: a replay after new routing is copied in gives the new product,
    and the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import grouped_mm_ref
    from repro_torch.kernels.grouped_mm.kernel import grouped_mm_cuda
    gen = torch.Generator("cuda").manual_seed(1)
    M, K, N, E = 96, 128, 256, 16
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    w = torch.randn(E, K, N, generator=gen, device="cuda").to(dtype)
    off = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(2)

    def route(n_rows):
        sizes = np.bincount(rng.integers(0, E, n_rows), minlength=E)
        off.copy_(torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                                   .astype(np.int32)))
    route(M)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        grouped_mm_cuda(x, w, off)          # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grouped_mm_cuda(x, w, off)
    for n_rows in (M, 40, 0, M):
        route(n_rows)
        graph.replay()
        first = out.clone()
        graph.replay()
        want = grouped_mm_ref(x, w, off)
        torch.cuda.synchronize()
        assert torch.equal(first, out)
        assert _rel(want, out) <= GMM_TOL[dtype] if n_rows else \
            not out.any()


@pytest.mark.gpu
@pytest.mark.parametrize("swiglu", [False, True])
def test_grouped_mm_wgmma_tma_replays_with_new_offsets(swiglu):
    """The wgmma_tma variant (and its epilogue) captured once: replays
    after new routing give the new product, twice the same bits, and the
    rows of no expert zero; one routing puts 600 rows in one expert."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import (grouped_mm_ref,
                                                grouped_mm_swiglu_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda, plan)
    kern = grouped_mm_swiglu_cuda if swiglu else grouped_mm_cuda
    ref = grouped_mm_swiglu_ref if swiglu else grouped_mm_ref
    gen = torch.Generator("cuda").manual_seed(3)
    M, K, N, E = 1024, 256, 384, 16
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(E, K, N, generator=gen, device="cuda")
         * K ** -0.5).bfloat16()
    assert plan(x, w, swiglu) == "wgmma_tma"
    off = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(4)

    def route(sizes, head=0):
        off.copy_(torch.from_numpy((head + np.concatenate(
            [[0], np.cumsum(sizes)])).astype(np.int32)))
    route(np.bincount(rng.integers(0, E, M), minlength=E))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        kern(x, w, off)                     # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern(x, w, off)
    for sizes, head in (
            (np.bincount(rng.integers(0, E, M), minlength=E), 0),
            (np.bincount(rng.integers(0, E, 300), minlength=E), 50),
            ([0] * 3 + [600] + [0] * 12, 100), ([0] * E, 7)):
        route(sizes, head)
        graph.replay()
        first = out.clone()
        graph.replay()
        want = ref(x, w, off)
        torch.cuda.synchronize()
        assert torch.equal(first, out)
        assert _rel(want, out) <= GMM_TOL[torch.bfloat16] if sum(sizes) \
            else not out.any()
        lo, hi = int(off[0]), int(off[-1])
        assert not out[:lo].any() and not out[hi:].any()


@pytest.mark.gpu
def test_grouped_mm_wrapper_refuses_bad_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_swiglu_cuda)
    bf = torch.bfloat16
    x = torch.zeros(8, 16, device="cuda", dtype=bf)
    w = torch.zeros(2, 16, 8, device="cuda", dtype=bf)
    off = torch.tensor([0, 4, 8], dtype=torch.int32, device="cuda")
    grouped_mm_cuda(x, w, off)
    with pytest.raises(TypeError):                  # offsets not int32
        grouped_mm_cuda(x, w, off.long())
    with pytest.raises(TypeError):                  # mixed dtypes
        grouped_mm_cuda(x.float(), w, off)
    with pytest.raises(ValueError):                 # E + 1 offsets
        grouped_mm_cuda(x, w, off[:2])
    with pytest.raises(ValueError):                 # K mismatch
        grouped_mm_cuda(x[:, :8].contiguous(), w, off)
    with pytest.raises(ValueError):                 # bf16 N not a multiple of 8
        grouped_mm_cuda(x, torch.zeros(2, 16, 12, device="cuda", dtype=bf),
                        off)
    with pytest.raises(ValueError):                 # not contiguous
        grouped_mm_cuda(x.t().contiguous().t(), w, off)
    with pytest.raises(ValueError):                 # an operand on the CPU
        grouped_mm_cuda(x, w.cpu(), off)
    with pytest.raises(ValueError):                 # a variant of fp32
        grouped_mm_cuda(x, w, off, variant="simt")
    with pytest.raises(ValueError):                 # swiglu: N % 16
        grouped_mm_swiglu_cuda(x, w, off)
    with pytest.raises(ValueError):                 # swiglu: odd fp32 N
        grouped_mm_swiglu_cuda(x.float(), torch.zeros(
            2, 16, 7, device="cuda"), off)
    assert grouped_mm_swiglu_cuda(
        x, torch.zeros(2, 16, 16, device="cuda", dtype=bf), off).shape \
        == (8, 8)


# ---------------------------------------------------------------------------
# The resilience layer and the service on the card (reduced configs, fp32,
# where replays give the same tokens whatever the batch): a guarded engine
# under tests/test_chaos.py's seeded soak, an armed guard with no fault, and
# a short service pass whose engine thread captures every step graph.
# ---------------------------------------------------------------------------

GMM_GRAD_CASES = GMM_VARIANT_CASES + [
    (64, 4096, 3072, 128, "top8", 0),       # qwen3-moe w1, batch-8 decode
    (53, 37, 70, 4, [7, 0, 24, 19], 0),     # fp32 only: K, N no tile divides
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_backward_kernels_match_plain_versions(case, dtype):
    """dgrad (dy w[e]^T) and wgrad (x[rows]^T dy[rows]) on the card against
    their plain versions: rows of no expert and experts with no rows exact
    zeros, each launch counted on its variant, a second call the same
    bits (no atomics, no split over blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import (grouped_mm_dgrad_ref,
                                                grouped_mm_wgrad_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grad_route, grouped_mm_dgrad_cuda, grouped_mm_wgrad_cuda)
    if dtype == torch.bfloat16 and (case[1] % 8 or case[2] % 8):
        pytest.skip("bf16 takes K and N multiples of 8")
    x, w, offsets = _gmm_case(case, dtype, seed=case[0] + 1)
    M, N = x.shape[0], w.shape[2]
    gen = torch.Generator("cuda").manual_seed(7)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    variant = grad_route(dtype, w.shape[1], N)
    counts = (grouped_mm_dgrad_cuda.launches,
              grouped_mm_wgrad_cuda.by_variant[variant])
    dx = grouped_mm_dgrad_cuda(dy, w, offsets)
    dw = grouped_mm_wgrad_cuda(x, dy, offsets)
    assert grouped_mm_dgrad_cuda.launches == counts[0] + 1
    assert grouped_mm_wgrad_cuda.by_variant[variant] == counts[1] + 1
    torch.cuda.synchronize()
    assert _rel(grouped_mm_dgrad_ref(dy, w, offsets), dx) <= GMM_TOL[dtype]
    assert _rel(grouped_mm_wgrad_ref(x, dy, offsets), dw) <= GMM_TOL[dtype]
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not dx[:lo].any() and not dx[hi:].any()
    for e in range(w.shape[0]):
        if offsets[e] == offsets[e + 1]:
            assert not dw[e].any()
    assert torch.equal(dx, grouped_mm_dgrad_cuda(dy, w, offsets))
    assert torch.equal(dw, grouped_mm_wgrad_cuda(x, dy, offsets))


GMM_GRAD_BF16_CASES = GMM_VARIANT_CASES + [
    # one expert of 1000 rows (8 row tiles, a ragged 64-row stage), K and N
    # multiples of 8 and not of 64, rows past offsets[E]
    (1100, 264, 136, 3, [37, 1000, 0], 0),
    # skewed: one hot expert of 2000 rows beside experts of 1-63 rows and
    # empty ones, rows before offsets[0]
    (2300, 128, 256, 12, [2000, 1, 0, 63, 64, 65, 0, 2, 0, 30, 9, 0], 17),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_GRAD_BF16_CASES)
def test_grouped_mm_backward_bf16_edge_cases_match_plain_versions(case):
    """bf16 dgrad and wgrad (wgmma_tma) against the plain versions: experts
    whose rows are no multiple of 64 or 128, empty experts, one expert of
    several row tiles, rows before offsets[0] and past offsets[E], K and N
    multiples of 8 and not of 64, and the forward's decode-sized cases; rows
    of no expert and experts with no rows exact zeros; a second call the
    same bits (one block an output tile, rows summed in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import (grouped_mm_dgrad_ref,
                                                grouped_mm_wgrad_ref)
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_dgrad_cuda, grouped_mm_wgrad_cuda)
    dtype = torch.bfloat16
    x, w, offsets = _gmm_case(case, dtype, seed=case[0] + 2)
    M, N = x.shape[0], w.shape[2]
    gen = torch.Generator("cuda").manual_seed(11)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    counts = (grouped_mm_dgrad_cuda.by_variant["wgmma_tma"],
              grouped_mm_wgrad_cuda.by_variant["wgmma_tma"])
    dx = grouped_mm_dgrad_cuda(dy, w, offsets)
    dw = grouped_mm_wgrad_cuda(x, dy, offsets)
    assert grouped_mm_dgrad_cuda.by_variant["wgmma_tma"] == counts[0] + 1
    assert grouped_mm_wgrad_cuda.by_variant["wgmma_tma"] == counts[1] + 1
    torch.cuda.synchronize()
    assert dx.shape == (M, w.shape[1]) and dw.shape == w.shape
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert _rel(grouped_mm_dgrad_ref(dy, w, offsets), dx) <= GMM_TOL[dtype]
    assert _rel(grouped_mm_wgrad_ref(x, dy, offsets), dw) <= GMM_TOL[dtype]
    lo, hi = int(offsets[0]), int(offsets[-1])
    assert not dx[:lo].any() and not dx[hi:].any()
    for e in range(w.shape[0]):
        if offsets[e] == offsets[e + 1]:
            assert not dw[e].any()
    assert torch.equal(dx, grouped_mm_dgrad_cuda(dy, w, offsets))
    assert torch.equal(dw, grouped_mm_wgrad_cuda(x, dy, offsets))


@pytest.mark.gpu
@pytest.mark.parametrize("swiglu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_autograd_on_the_card_matches_the_cpu(swiglu, dtype):
    """The training route: the ops' backward on the card (the swiglu one
    recomputing the product with the forward kernel) against the same
    autograd functions on the CPU (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.grouped_mm import grouped_mm, grouped_mm_swiglu
    from repro_torch.kernels.grouped_mm.kernel import (
        grouped_mm_cuda, grouped_mm_dgrad_cuda, grouped_mm_wgrad_cuda)
    fn = grouped_mm_swiglu if swiglu else grouped_mm
    x, w, offsets = _gmm_case((1024, 256, 384, 16, "top8", 0), dtype, 3)
    dy = torch.randn((1024, 192 if swiglu else 384), device="cuda").to(dtype)
    outs = []
    for dev in ("cuda", "cpu"):
        xs = x.detach().to(dev).requires_grad_(True)
        ws = w.detach().to(dev).requires_grad_(True)
        n = (grouped_mm_cuda.launches, grouped_mm_dgrad_cuda.launches,
             grouped_mm_wgrad_cuda.launches)
        y = fn(xs, ws, offsets.to(dev))
        y.backward(dy.to(dev))
        if dev == "cuda":
            assert grouped_mm_dgrad_cuda.launches == n[1] + 1
            assert grouped_mm_wgrad_cuda.launches == n[2] + 1
            # the plain product's forward, or the swiglu backward's
            # recomputed product
            assert grouped_mm_cuda.launches == n[0] + 1
        outs.append([t.detach().float().cpu() for t in (y, xs.grad,
                                                         ws.grad)])
    for a, b in zip(*outs):
        assert _rel(b, a) <= GMM_TOL[dtype]


@pytest.mark.gpu
def test_forward_only_ops_raise_under_autograd_on_the_card():
    """On a CUDA tensor that requires grad, with grad mode on, every
    forward-only kernel op raises naming itself instead of returning an
    output with no history; under no_grad the same calls run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_mm.kernel import (grouped_mm_cuda,
                                                       grouped_mm_swiglu_cuda)
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.default_rng(0)
    table, arenas, q, q_pos = _case(rng, B=2, T=4, stride=4, kvh=2, hd=64,
                                    Hq=4, qrows=1, L=1)
    kc, vc = (torch.from_numpy(a).cuda() for a in arenas[0])
    qd = torch.from_numpy(q).cuda().requires_grad_(True)
    tab, pos = torch.from_numpy(table).cuda(), torch.from_numpy(q_pos).cuda()
    x = torch.randn(1, 16, 2, 64, device="cuda", requires_grad=True)
    dt = torch.rand(1, 16, 2, device="cuda")
    A = -torch.rand(2, device="cuda")
    bc = torch.randn(1, 16, 1, 16, device="cuda")
    qa = torch.randn(1, 2, 16, 64, device="cuda", requires_grad=True)
    xg = torch.randn(8, 16, device="cuda", requires_grad=True)
    wg = torch.randn(2, 16, 32, device="cuda")
    off = torch.tensor([0, 3, 8], dtype=torch.int32, device="cuda")
    calls = {
        "paged_attention_cuda": lambda: paged_attention(
            qd, kc, vc, tab, pos, stride=4),
        "flash_attention_cuda": lambda: flash_attention(qa, qa, qa),
        "ssd_chunk_cuda": lambda: ssd_scan(x, dt, A, bc, bc, chunk=8),
        "grouped_mm_cuda": lambda: grouped_mm_cuda(xg, wg, off),
        "grouped_mm_swiglu_cuda": lambda: grouped_mm_swiglu_cuda(xg, wg,
                                                                 off),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _card_engine(name, **kw):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve.engine import EngineConfig, build_engine
    cfg = dataclasses.replace(reduced(get_config(name)),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    return build_engine(cfg, seed=0, engine_cfg=EngineConfig(
        s_max=64, buckets=(1, 2, 4), block_pos_stride=8,
        prefill_chunks=(16,), device="cuda", **kw))


def _card_prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 30))).tolist()
            for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-780m"])
def test_guarded_engine_on_the_card(name):
    """The soak's faults (launch, device, nan, pool, stall) on the card:
    survivors keep the unguarded tokens, pools drain, every replay is a
    launch or a device fault; a guard with no injector changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.serve.engine import SamplingParams, generate
    from repro_torch.serve.resilience import FaultInjector, ResilienceConfig
    plain = _card_engine(name)
    prompts = _card_prompts(plain.cfg.vocab_size, 8, 7)
    sp = SamplingParams(max_tokens=12)
    want = generate(plain, prompts, sp)
    quiet = _card_engine(name, resilience=ResilienceConfig())
    quiet.params = plain.params
    assert [c.tokens for c in generate(quiet, prompts, sp)] == \
        [c.tokens for c in want]
    assert dataclasses.asdict(quiet.stats) == dataclasses.asdict(plain.stats)
    inj = FaultInjector(1234, {"launch": 0.10, "device": 0.08,
                               "nan_logits": 0.04, "pool": 0.08,
                               "stall": 0.03}, stall_s=0.001, max_faults=60)
    eng = _card_engine(name, fault_injector=inj,
                       resilience=ResilienceConfig(max_request_failures=2))
    eng.params = plain.params
    got = generate(eng, prompts, sp)
    assert inj.n_fired > 0
    for g, w in zip(got, want):
        if g.finish_reason != "error":
            assert g.tokens == w.tokens
    assert eng.pool.n_free == eng.pool.n_blocks
    assert eng.store.slot_pool is None or eng.store.slot_pool.n_used == 0
    replayed = sum(ev.launches for ev in eng.kernel_events().values())
    assert replayed == eng.stats.launches + inj.counts()["device"]


@pytest.mark.gpu
def test_service_on_the_card_captures_on_its_engine_thread():
    """Six concurrent streams through the service on a fresh engine: the
    engine thread captures every step graph, and the streams give the
    tokens of ``generate()`` on an engine of the same config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import asyncio
    import threading
    from repro_torch.core.hybrid import StepGraph
    from repro_torch.serve.engine import SamplingParams, generate
    from repro_torch.serve.service import GenerateService
    ref = _card_engine("qwen2-0.5b")
    prompts = _card_prompts(ref.cfg.vocab_size, 6, 3)
    want = generate(ref, prompts, SamplingParams(max_tokens=8))
    eng = _card_engine("qwen2-0.5b")
    eng.params = ref.params
    threads, build = [], eng.queue.build

    def build_on(*args):
        threads.append(threading.current_thread().name)
        return build(*args)
    eng.queue.build = build_on

    async def main():
        async with GenerateService(eng) as svc:
            streams = [await svc.submit(p, max_tokens=8) for p in prompts]
            return await asyncio.gather(*[s.drain() for s in streams])

    got = asyncio.run(main())
    assert [t for t, _ in got] == [c.tokens for c in want]
    assert threads and set(threads) == {"engine-loop"}
    assert all(isinstance(e, StepGraph)
               for e in eng.queue._compiled.values())
    assert eng.pool.n_free == eng.pool.n_blocks



@pytest.mark.gpu
def test_step_capture_survives_dead_engines_in_cycles():
    """Step graphs are captured while dead engines (their graphs, pinned
    operands and logits buffers, all once used) wait in reference cycles
    and the collector's threshold asks for a collection at nearly every
    allocation: every capture completes, the collector is on again after
    each build, and the tokens are those of an engine built before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import gc
    from repro_torch.serve.engine import SamplingParams, generate
    sp = SamplingParams(max_tokens=6)
    ref = _card_engine("qwen2-0.5b")
    prompts = _card_prompts(ref.cfg.vocab_size, 4, 5)
    want = [c.tokens for c in generate(ref, prompts, sp)]
    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            dead = _card_engine("qwen2-0.5b")
            dead.params = ref.params
            generate(dead, prompts, sp)
            dead.cycle = dead                # only a collection frees it
            del dead
        gc.set_threshold(1, 1, 1)
        eng = _card_engine("qwen2-0.5b")
        eng.params = ref.params
        got = [c.tokens for c in generate(eng, prompts, sp)]
        assert gc.isenabled()
    finally:
        gc.set_threshold(*threshold)
        gc.collect()
    assert got == want


@pytest.mark.gpu
def test_every_library_launches_first_on_a_fresh_thread():
    """Each kernel library's first call in a fresh process, on a new
    thread (and the grouped GEMM's inside a backward, on the autograd
    engine's thread), launches and gives the main thread's bits
    (``repro_torch.launch.fresh_thread``: paged attention, the three SSD
    entry points, cannon_mm bf16 and fp32, flash attention, the grouped
    GEMM with and without its epilogue, dgrad and wgrad, the symmetric
    heap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.fresh_thread import CASES, run_all
    rows = run_all()
    assert [r["case"] for r in rows] == list(CASES)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_heap_kernels_match_plain(dtype):
    """The symmetric heap's put and reduce_slots against their plain
    versions on one heap of this process: bytes equal, and sums and maxes
    over 1, 2 and 3 slots bit for bit (both add in slot order in fp32), at
    small sizes and at 3000001 elements, where the kernels' grid-stride
    loops run many passes (the launch covers 270336 threads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.shmem_heap import (CudaHeap, shmem_put_ref,
                                                shmem_reduce_slots_ref)
    from repro_torch.kernels.shmem_heap.kernel import (
        shmem_put_cuda, shmem_reduce_slots_cuda)
    heap = CudaHeap(0, 1, 1 << 26, torch.device("cuda", 0))
    heap.open_peers([heap.handle])
    try:
        g = torch.Generator(device="cuda").manual_seed(3)
        for numel, off in ((4096, 0), (999, 4096 + 5), (3000001, 0),
                           (3000001, 7)):
            src = torch.randn(numel, generator=g, device="cuda").to(dtype)
            heap.views[0].fill_(0xA5)
            shmem_put_cuda(heap, src, 0, off)
            torch.cuda.synchronize()
            raw = src.view(torch.uint8)
            assert torch.equal(heap.views[0][off:off + raw.numel()], raw)
        stride = 1 << 24
        for numel in (5000, 3000001):
            for k in range(3):
                shmem_put_ref(heap, torch.randn(numel, generator=g,
                                                device="cuda").to(dtype),
                              0, k * stride)
            for out in (torch.float32, torch.bfloat16):
                for op in ("sum", "max"):
                    for n in (1, 2, 3):
                        got = shmem_reduce_slots_cuda(
                            heap, 0, stride, n, (numel,), dtype, out, op)
                        want = shmem_reduce_slots_ref(
                            heap, 0, stride, n, (numel,), dtype, out, op)
                        assert torch.equal(got, want), (numel, out, op, n)
    finally:
        heap.close_peers()
        heap.free()


@pytest.mark.gpu
def test_cuda_pe_grid_matches_the_cpu_grid():
    """Every PeGrid collective on four PE processes of the card (heaps over
    CUDA IPC) against the same four PEs on the CPU: permutations and
    gathers equal, sums within fp32 rel 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.pe_grid import probe_collectives
    from repro_torch.partition import grid_plan
    from repro_torch.runtime.pe import run_pes
    rng = np.random.default_rng(4)
    inputs = {"x": rng.standard_normal((4, 4, 6)).astype(np.float32),
              "vec": rng.standard_normal((4, 3, 8)).astype(np.float32),
              "w": rng.standard_normal((4, 8, 5)).astype(np.float32)}
    card = run_pes(probe_collectives, grid_plan(2, 2), args=(inputs,),
                   device="cuda", timeout=120)
    host = run_pes(probe_collectives, grid_plan(2, 2), args=(inputs,),
                   device="cpu", timeout=120)
    for pe in range(4):
        for op, want in host[pe].items():
            if op in ("psum_rows", "psum_cols", "reduce_scatter_rows",
                      "gemv2d"):
                np.testing.assert_allclose(card[pe][op], want, rtol=1e-6,
                                           atol=1e-6, err_msg=op)
            else:
                np.testing.assert_array_equal(card[pe][op], want,
                                              err_msg=op)
