"""The grouped GEMM's backward (plain versions, the CPU route of its
autograd functions) against ``jax.vjp`` through ``lax.ragged_dot``.

Skewed group sizes (one expert holds most rows), empty experts, rows past
``offsets[E]`` (which ``ragged_dot`` leaves zero and which get no
gradient); the product alone (dgrad ``dy w[e]^T``, wgrad
``x[rows]^T dy[rows]``) and with the MoE block's silu x up
(``moe.py:116-119``: the product recomputed, the cotangent of gate | up
formed with silu' in fp32).  fp32 within rel 1e-5 (the same products,
another summation order); bf16 within 2^-7 of the largest element (both
round each product once to bf16 and the silu where the JAX block rounds;
what is left is the fp32 summation order at a bf16 rounding boundary).
Rows before ``offsets[0]``, which ``ragged_dot`` cannot express, get no
gradient and add nothing to dw.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro_torch.kernels.grouped_mm import (grouped_mm, grouped_mm_dgrad_ref,
                                            grouped_mm_swiglu,
                                            grouped_mm_wgrad_ref)

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
SIZES = [0, 3, 0, 41, 1, 0, 0, 9, 0, 2]       # skewed, empty experts
M, K, N = 64, 24, 32                          # 8 rows past offsets[E]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))


def _inputs(dtype, n_out):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((len(SIZES), K, N)) / np.sqrt(K)).astype(
        np.float32)
    ct = rng.standard_normal((M, n_out)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    j = [jnp.asarray(a).astype(jd) for a in (x, w, ct)]
    t = [torch.from_numpy(a).to(td) for a in (x, w, ct)]
    off = torch.tensor(np.concatenate([[0], np.cumsum(SIZES)]),
                       dtype=torch.int32)
    return j, t, off


def _jax_fn(swiglu):
    gs = jnp.asarray(SIZES, jnp.int32)

    def f(x, w):
        h = lax.ragged_dot(x, w, gs)
        if not swiglu:
            return h
        F = w.shape[2] // 2
        return (jax.nn.silu(h[:, :F].astype(jnp.float32)).astype(h.dtype)
                * h[:, F:])
    return f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swiglu", [False, True])
def test_backward_matches_jax_vjp_of_ragged_dot(dtype, swiglu):
    (xj, wj, ctj), (xt, wt, ctt), off = _inputs(
        dtype, N // 2 if swiglu else N)
    yj, vjp = jax.vjp(_jax_fn(swiglu), xj, wj)
    dxj, dwj = vjp(ctj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    yt = (grouped_mm_swiglu if swiglu else grouped_mm)(xt, wt, off)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), ctt)
    assert dxt.dtype == xt.dtype and dwt.dtype == wt.dtype
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    assert _rel(f32(yj), yt.detach().float().numpy()) <= TOL[dtype]
    assert _rel(f32(dxj), dxt.float().numpy()) <= TOL[dtype]
    assert _rel(f32(dwj), dwt.float().numpy()) <= TOL[dtype]
    # rows past offsets[E] get no gradient; empty experts a zero dw
    assert not dxt[int(off[-1]):].any()
    for e, n in enumerate(SIZES):
        if n == 0:
            assert not dwt[e].any()


def test_rows_before_the_first_offset_take_no_part():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((20, 6)).astype(np.float32))
    off = torch.tensor([4, 9, 9, 15], dtype=torch.int32)
    dx = grouped_mm_dgrad_ref(dy, w, off)
    assert not dx[:4].any() and not dx[15:].any()
    torch.testing.assert_close(dx[4:9], dy[4:9] @ w[0].T)
    dw = grouped_mm_wgrad_ref(x, dy, off)
    torch.testing.assert_close(dw[0], x[4:9].T @ dy[4:9])
    assert not dw[1].any()
    torch.testing.assert_close(dw[2], x[9:15].T @ dy[9:15])
