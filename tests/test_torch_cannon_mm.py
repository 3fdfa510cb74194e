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
