"""repro_torch's matmul op (its plain version, on the CPU) against the JAX
``blocked_matmul``: the Pallas kernel in interpret mode where the shape
divides into its blocks, its reference ``matmul_ref`` where it does not.

Tolerances, stated per dtype: fp32 max abs difference over max abs value
< 1e-5 (fp32 sums over K in another order); bf16 within one bf16 ulp of
the JAX element (exact products and fp32 sums in both, then one rounding
to bf16, which an fp32 sum that differs in its last bits can flip).
The gradient goes through the op's ``autograd.Function`` (the plain
version on transposed views) and is held against ``jax.grad`` of the JAX
reference, to the same tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.cannon_mm import blocked_matmul as j_blocked_matmul
from repro.kernels.cannon_mm import matmul_ref as j_matmul_ref
from repro_torch.kernels.cannon_mm import blocked_matmul, matmul_ref

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    outs = []
    for s in shapes:
        x = rng.standard_normal(s).astype(np.float32)
        j = jnp.asarray(x, JDT[dtype])
        outs.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                     .to(dtype)))
    return outs


def _close(want, got, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.double().numpy()
    if dtype == torch.float32:
        assert np.abs(want - got).max() / np.abs(want).max() < 1e-5
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                      - 7)
        assert (np.abs(want - got) <= ulp).all()


@pytest.mark.parametrize("mkn,blocks", [
    # tests/test_kernels.py:16 shapes, then a ragged one (JAX: reference)
    ((256, 256, 256), (128, 128, 128)),
    ((512, 256, 384), (256, 128, 128)),
    ((128, 512, 128), (128, 128, 256)),
    ((100, 37, 130), (128, 128, 128)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_blocked_matmul_matches_jax(mkn, blocks, dtype, out_dtype):
    M, K, N = mkn
    bm, bn, bk = blocks
    (ja, a), (jb, b) = _operands(sum(mkn), [(M, K), (K, N)], dtype)
    jout = None if out_dtype is None else jnp.float32
    want = j_blocked_matmul(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                            out_dtype=jout, force_interpret=True)
    n0 = matmul_ref.launches
    got = blocked_matmul(a, b, out_dtype=out_dtype)
    assert matmul_ref.launches == n0 + 1
    assert got.dtype == (out_dtype or dtype) and got.shape == (M, N)
    _close(want, got, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_and_strided_operands_match_jax(dtype):
    """A PE stack (one launch for all 16) and transposed views."""
    (ja, a), (jb, b) = _operands(1, [(16, 24, 40), (16, 40, 32)], dtype)
    want = jax.vmap(j_matmul_ref)(ja, jb)
    got = blocked_matmul(a, b)
    _close(want, got, dtype)
    got_t = blocked_matmul(b.transpose(1, 2), a.transpose(1, 2))
    _close(jnp.swapaxes(want, 1, 2), got_t, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_matches_jax_grad(dtype):
    (ja, a), (jb, b) = _operands(2, [(48, 64), (64, 40)], dtype)
    g = np.random.default_rng(3).standard_normal((48, 40)).astype(np.float32)

    def loss(x, y):
        return jnp.sum(j_matmul_ref(x, y, jnp.float32) * g)

    jga, jgb = jax.grad(loss, argnums=(0, 1))(ja, jb)
    a.requires_grad_()
    b.requires_grad_()
    n0 = matmul_ref.launches
    (blocked_matmul(a, b, out_dtype=torch.float32)
     * torch.from_numpy(g)).sum().backward()
    assert matmul_ref.launches == n0 + 3     # forward, dA, dB
    assert a.grad.dtype == dtype and b.grad.dtype == dtype
    _close(jga, a.grad, dtype)
    _close(jgb, b.grad, dtype)


# ---------------------------------------------------------------------------
# The planner: which variant of the CUDA family takes a call.  It reads
# dtypes, shapes, strides and base alignment only, so it runs here; the
# main path's operand stacks are built on the meta device at their real
# sizes (no data) by running every strategy with the product recorded.
# ---------------------------------------------------------------------------

from repro_torch.core import ShmemGrid
from repro_torch.core import cannon as t_cannon
from repro_torch.kernels.cannon_mm.kernel import (WGMMA_BOX_A, WGMMA_BOX_B,
                                                  plan, tma_args)
from repro_torch.kernels.cannon_mm.ops import _same_dtype
from repro_torch.launch import table1

STRATEGY_LAUNCHES = {"cannon": 4, "cannon_preskewed": 4, "crot": 4,
                     "allgather": 1, "summa": 4, "gemv2d": 1}


def _main_path_operands(spec, monkeypatch):
    """(strategy, a, b) of every local product of every strategy at a
    Table 1 size, as chip_smoke.py's cannon phase runs them."""
    M, K, N, dtype = table1.parse_size(spec)
    calls = []

    def record(a, b, *, out_dtype=None):
        calls.append((name, a, b))
        return torch.empty(a.shape[:-1] + b.shape[-1:],
                           dtype=out_dtype or a.dtype, device=a.device)

    monkeypatch.setattr(t_cannon, "blocked_matmul", record)
    q, g = 4, ShmemGrid(4, 4)
    A = torch.empty(M, K, dtype=dtype, device="meta")
    B = torch.empty(K, N, dtype=dtype, device="meta")
    a, nat = t_cannon.block_2d(A, q, q), t_cannon.block_2d(B, q, q)
    x = A[:8]
    xs = torch.stack([x[:, (p % q) * (K // q):(p % q + 1) * (K // q)]
                      for p in range(q * q)])
    runs = {
        "cannon": lambda: t_cannon.cannon_matmul(g, a, nat),
        "cannon_preskewed": lambda: t_cannon.cannon_matmul(
            g, a, t_cannon.block_2d(B, q, q, True), preskewed_b=True),
        "crot": lambda: t_cannon.cannon_matmul_crot(
            g, a, t_cannon.block_2d(B, q, q, "crot")),
        "allgather": lambda: t_cannon.allgather_matmul(g, a, nat),
        "summa": lambda: t_cannon.summa_matmul(g, a, nat),
        "gemv2d": lambda: t_cannon.gemv2d(g, xs, nat),
    }
    for name, run in runs.items():
        run()
    return dtype, calls


@pytest.mark.parametrize("spec", table1.DEFAULT_SIZES)
def test_main_path_stacks_take_the_fast_variants(spec, monkeypatch):
    """Every local product of every strategy at every Table 1 size: bf16
    on wgmma_tma, fp32 on f32_vec."""
    dtype, calls = _main_path_operands(spec, monkeypatch)
    want = "wgmma_tma" if dtype == torch.bfloat16 else "f32_vec"
    counts = {}
    for name, a, b in calls:
        counts[name] = counts.get(name, 0) + 1
        got = plan(a, b, torch.float32)
        assert got.variant == want, (spec, name, a.shape, a.stride(),
                                     b.shape, b.stride(), got)
        if want == "f32_vec":
            assert got.layout == 2          # A along K, B along N
    assert counts == STRATEGY_LAUNCHES


@pytest.mark.parametrize("dtype,want", [(torch.float32, "f32_general"),
                                        (torch.bfloat16, "mma_general")])
def test_unaligned_layouts_take_the_general_variants(dtype, want):
    """Rows that are not 16-byte aligned, an odd batch stride and a base
    off 16 bytes go to the general variant of the same family."""
    a = torch.zeros(100, 37, dtype=dtype)
    b = torch.zeros(37, 130, dtype=dtype)
    assert plan(a, b).variant == want
    buf = torch.zeros(16 * (64 * 48 + 3) + 16, dtype=dtype)
    odd = buf.as_strided((16, 64, 48), (64 * 48 + 3, 48, 1))
    stack = torch.zeros(16, 48, 40, dtype=dtype)
    assert plan(odd, stack).variant == want
    assert plan(stack.transpose(1, 2), odd.transpose(1, 2)).variant == want
    shifted = buf[1:1 + 64 * 48].view(64, 48)      # base 4 or 2 bytes off
    assert shifted.data_ptr() % 16 != 0
    assert plan(shifted, torch.zeros(48, 40, dtype=dtype)).variant == want
    # the aligned counterparts take the fast variant
    fast = "f32_vec" if dtype == torch.float32 else "wgmma_tma"
    assert plan(torch.zeros(100, 64, dtype=dtype),
                torch.zeros(64, 136, dtype=dtype)).variant == fast


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transposed_views_take_the_stated_variant(dtype):
    """fp32: a.t() (unit stride along M) and b.t() (along K) stay on
    f32_vec, with its layout bits; bf16: transposed views go to
    mma_general (wgmma_tma takes K-major A and N-major B only)."""
    a = torch.zeros(96, 200, dtype=dtype)           # a.t(): (200, 96)
    b = torch.zeros(72, 96, dtype=dtype)            # b.t(): (96, 72)
    a_nat, b_nat = a.t().contiguous(), b.t().contiguous()
    cases = {(True, False): (a.t(), b_nat), (False, True): (a_nat, b.t()),
             (True, True): (a.t(), b.t())}
    for (ta, tb), (x, y) in cases.items():
        got = plan(x, y)
        if dtype == torch.float32:
            assert got.variant == "f32_vec"
            assert got.layout == int(ta) | 2 * int(not tb)
        else:
            assert got.variant == "mma_general"


def test_backward_operands_take_an_fp32_variant():
    """The backward multiplies the fp32 cotangent with the transposed bf16
    operand widened to fp32 (ops.py): both products plan f32_vec."""
    a = torch.zeros(16, 48, 64, dtype=torch.bfloat16)
    b = torch.zeros(16, 64, 40, dtype=torch.bfloat16)
    g = torch.zeros(16, 48, 40)
    for x, y in (_same_dtype(g, b.transpose(-1, -2)),
                 _same_dtype(a.transpose(-1, -2), g)):
        assert x.dtype == y.dtype == torch.float32
        assert plan(x, y).variant == "f32_vec"


def test_tma_arguments_of_the_main_path_shapes():
    """Tensor-map arguments of the bf16 Cannon stacks at 4096x896x4864
    (per PE (1024 x 224) @ (224 x 1216)): dims innermost first, byte
    strides in multiples of 16, a 128-byte box row (the swizzle span)."""
    A = torch.zeros(16, 1024, 224, dtype=torch.bfloat16)
    B = torch.zeros(16, 224, 1216, dtype=torch.bfloat16)
    got = plan(A, B, torch.float32)
    assert got.variant == "wgmma_tma" and got.tile == (128, 256, 64)
    ma = tma_args(A.shape, A.stride(), 2, WGMMA_BOX_A)
    mb = tma_args(B.shape, B.stride(), 2, WGMMA_BOX_B)
    assert ma == (224, 1024, 16, 448, 1024 * 448, 64, 128, 1)
    assert mb == (1216, 224, 16, 2432, 224 * 2432, 64, 64, 1)
    assert got.tma == ma + mb
    for m in (ma, mb):
        assert m[3] % 16 == 0 and m[4] % 16 == 0
        assert m[5] * 2 == 128 and max(m[5:]) <= 256
    # one matrix: the batch stride is the dense one
    assert tma_args((1, 100, 64), (0, 64, 1), 2, WGMMA_BOX_A)[3:5] == \
        (128, 12800)
    # rows of 37 bf16 (74 bytes), or a non-unit column stride: no map
    assert tma_args((1, 100, 37), (3700, 37, 1), 2, WGMMA_BOX_A) is None
    assert tma_args((1, 96, 72), (6912, 1, 96), 2, WGMMA_BOX_B) is None
