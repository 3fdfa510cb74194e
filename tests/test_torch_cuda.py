"""The port's CUDA kernels against their plain versions, on the card:
paged attention, the two SSD-scan passes, the cannon_mm matmul (forward,
backward, and one emulated Cannon call) and flash attention.

Needs a CUDA card and nvcc; skips without a card.  The file imports no
JAX, so on a machine without it run it past the suite's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: rel < 1e-5 with fp32 arenas, < 1e-3 with bf16 arenas (the
same bf16 inputs, fp32 arithmetic in both, another summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (merge_rows, paged_attention,
                                                 paged_attention_ref)


def _case(rng, *, B, T, stride, kvh, hd, Hq, qrows, L):
    n_blocks = B * T
    table = rng.permutation(n_blocks).astype(np.int32).reshape(B, T)
    table[-1, -1] = -1                       # unallocated tail entry
    table[0, 1] = -1                         # a hole mid-table
    n_loc = -(-n_blocks // qrows)
    arenas = [(rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32),
               rng.normal(size=(n_loc, stride, kvh, hd)).astype(np.float32))
              for _ in range(qrows)]
    q = rng.normal(size=(B, Hq, L, hd)).astype(np.float32)
    pos = rng.integers(0, T * stride - L + 1, size=B).astype(np.int32)
    return table, arenas, q, pos[:, None] + np.arange(L, dtype=np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", [
    # B, T, stride, kvh, hd, Hq, L, qrows
    (8, 32, 16, 2, 64, 14, 1, 1),        # qwen2-0.5b decode
    (2, 32, 16, 2, 64, 14, 256, 1),      # qwen2-0.5b prefill chunk
    (2, 8, 16, 8, 128, 16, 16, 1),       # hd 128, group 2
    (3, 4, 4, 4, 8, 8, 8, 2),            # reduced hd 8, two grid rows
    (2, 4, 8, 1, 32, 8, 3, 2),           # group 8, hd 32
    (2, 8, 8, 4, 16, 4, 5, 1),           # group 1, hd 16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(geometry, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, stride, kvh, hd, Hq, L, qrows = geometry
    rng = np.random.default_rng(sum(geometry))
    table, arenas, q, q_pos = _case(rng, B=B, T=T, stride=stride, kvh=kvh,
                                    hd=hd, Hq=Hq, qrows=qrows, L=L)
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
    (2, 128, 64, 8, 16, 1, 16, 0),         # reduced, nc = 2
    (2, 96, 32, 8, 16, 4, 16, 7),          # reduced G = 4, nc = 3
    (1, 40, 40, 6, 8, 3, 8, 0),            # ragged L, P = 8
    (1, 70, 70, 4, 128, 2, 40, 0),         # P = 128, ragged N
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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_kernel_matches_plain_version(pmkn, dtype, out_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref
    P, M, K, N = pmkn
    a, b = _mm_operands(np.random.default_rng(sum(pmkn)), P, M, K, N, dtype)
    if P == 1:
        a, b = a[0], b[0]
    got = blocked_matmul(a, b, out_dtype=out_dtype)
    want = matmul_ref(a, b, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(want, got) < MM_TOL[dtype]
    # transposed operands are read through their strides, not copied
    got_t = blocked_matmul(b.transpose(-1, -2), a.transpose(-1, -2),
                           out_dtype=out_dtype)
    want_t = matmul_ref(b.transpose(-1, -2), a.transpose(-1, -2), out_dtype)
    assert _rel(want_t, got_t) < MM_TOL[dtype]


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
