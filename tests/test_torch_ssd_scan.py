"""repro_torch's SSD scan (plain versions, CPU) against the JAX package's.

The same numpy inputs go through the JAX ``ssd_scan`` (the pure-jnp chunked
backend, and the Pallas kernels in interpret mode, as tests/test_kernels.py
runs them), the JAX sequential oracle ``ssd_ref``, and the port.

Tolerances: against the JAX chunked op rtol 1e-4, atol 1e-5 in fp32 — the
sums over L and N run in another order; against the sequential oracle the
JAX test's own rtol 1e-3, atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_decode_step as j_decode
from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.kernel import ssd_apply_pallas, ssd_chunk_pallas
from repro.kernels.ssd_scan.ops import _state_passing as j_state_passing
from repro_torch.kernels.ssd_scan import (_state_passing, ssd_apply_ref,
                                          ssd_chunk_ref, ssd_decode_step,
                                          ssd_ref, ssd_scan,
                                          ssd_scan_fused_ref)
from repro_torch.kernels.ssd_scan.kernel import Plan, apply_plan, plan

CHUNKED = dict(rtol=1e-4, atol=1e-5)
ORACLE = dict(rtol=1e-3, atol=1e-4)


def _inputs(seed, B, S, H, P, G, N, pad=0, init=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    if pad:
        dt[:, S - pad:] = 0.0            # padding columns: state-neutral
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.3).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dims", [
    # (B, S, H, P, G, N, chunk, pad, init) — tests/test_kernels.py:59
    (2, 256, 8, 16, 2, 32, 64, 0, False),
    (1, 128, 4, 32, 1, 16, 128, 0, False),
    (2, 128, 6, 8, 3, 8, 32, 0, False),
    (1, 64, 2, 64, 2, 64, 16, 0, False),
    # nc = 1 at the engine's chunk launches, padding columns, init state
    (3, 16, 8, 16, 4, 16, 16, 5, True),
    (2, 1, 8, 16, 1, 16, 1, 0, True),
    (2, 64, 4, 16, 2, 16, 32, 20, True),
], ids=lambda d: "B{}S{}H{}P{}G{}N{}L{}pad{}{}".format(
    *d[:8], "init" if d[8] else ""))
def test_ssd_scan_matches_jax(dims):
    B, S, H, P, G, N, L, pad, init = dims
    arrs = _inputs(sum(dims[:7]), B, S, H, P, G, N, pad, init)
    y, s = ssd_scan(*_t(*arrs), chunk=L)
    for backend in ("jnp", "pallas"):
        yj, sj = j_ssd_scan(*_j(*arrs), chunk=L, backend=backend,
                            interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **CHUNKED)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), **CHUNKED)
    yr, sr = j_ssd_ref(*_j(*arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **ORACLE)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **ORACLE)
    # the port's own sequential oracle agrees with the JAX one
    yo, so = ssd_ref(*_t(*arrs))
    np.testing.assert_allclose(yo.numpy(), np.asarray(yr), **CHUNKED)
    np.testing.assert_allclose(so.numpy(), np.asarray(sr), **CHUNKED)


@pytest.mark.parametrize("dims", [
    (2, 64, 8, 16, 2, 16, 32, 7),
    (1, 16, 48, 64, 1, 128, 16, 3),      # mamba2-780m head geometry
], ids=["reduced", "mamba2"])
def test_pass_plain_versions_match_the_pallas_kernels(dims):
    """Each plain version against the TPU kernel it stands for (Pallas in
    interpret mode), output by output; each counts one launch per call."""
    B, S, H, P, G, N, L, pad = dims
    x, dt, A, Bm, Cm, _ = _inputs(7, B, S, H, P, G, N, pad)
    n0 = (ssd_chunk_ref.launches, ssd_apply_ref.launches)
    got = ssd_chunk_ref(*_t(x, dt, A, Bm, Cm), chunk=L)
    want = ssd_chunk_pallas(*_j(x, dt, A, Bm, Cm), chunk=L, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CHUNKED)
    nc = S // L
    sin = np.random.default_rng(1).normal(
        size=(B, nc, H, N, P)).astype(np.float32)
    cr = Cm.reshape(B, nc, L, G, N)
    ya = ssd_apply_ref(got[0], torch.from_numpy(cr), got[2],
                       torch.from_numpy(sin))
    yj = ssd_apply_pallas(jnp.asarray(got[0].numpy()), jnp.asarray(cr),
                          jnp.asarray(got[2].numpy()), jnp.asarray(sin),
                          interpret=True)
    np.testing.assert_allclose(ya.numpy(), np.asarray(yj), **CHUNKED)
    assert (ssd_chunk_ref.launches, ssd_apply_ref.launches) == \
        (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("nc", [1, 4])
def test_state_passing_matches_jax(nc):
    rng = np.random.default_rng(nc)
    states = rng.normal(size=(2, nc, 3, 4, 5)).astype(np.float32)
    decay = rng.uniform(0.1, 1.0, size=(2, nc, 3)).astype(np.float32)
    init = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    s_in, fin = _state_passing(*_t(states, decay, init))
    js_in, jfin = j_state_passing(*_j(states, decay, init))
    np.testing.assert_allclose(s_in.numpy(), np.asarray(js_in), **CHUNKED)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **CHUNKED)
    if nc == 1:   # exactly init in, decay * init + state out
        assert torch.equal(s_in[:, 0], torch.from_numpy(init))
        assert torch.equal(fin, torch.from_numpy(
            decay[:, 0, :, None, None] * init + states[:, 0]))


def test_ssd_decode_step_matches_jax():
    B, H, P, G, N = 3, 8, 16, 2, 16
    x, dt, A, Bm, Cm, s0 = _inputs(11, B, 1, H, P, G, N, init=True)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], s0)
    y, st = ssd_decode_step(*_t(*args))
    yj, sj = j_decode(*_j(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **CHUNKED)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **CHUNKED)
    # a decode step continues the chunked scan exactly
    xs, dts, _, Bs, Cs, _ = _inputs(12, B, 16, H, P, G, N)
    _, fin = ssd_scan(*_t(xs, dts, A, Bs, Cs), chunk=16)
    yd, _ = ssd_decode_step(*_t(*args[:5]), fin)
    ys, _ = ssd_scan(*_t(x, dt, A, Bm, Cm), fin, chunk=1)
    np.testing.assert_allclose(yd.numpy(), ys[:, 0].numpy(), **CHUNKED)


def test_bf16_inputs_round_like_jax():
    """bf16 x/B/C: y_intra is rounded to bf16 before the apply pass adds
    the inter-chunk term in fp32 and rounds again, in both packages."""
    x, dt, A, Bm, Cm, s0 = _inputs(3, 2, 32, 4, 16, 2, 16, init=True)
    xb, Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    yj, sj = j_ssd_scan(xb, jnp.asarray(dt), jnp.asarray(A), Bb, Cb,
                        jnp.asarray(s0), chunk=16, backend="jnp")
    tb = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))) \
        .bfloat16()
    y, s = ssd_scan(tb(xb), torch.from_numpy(dt), torch.from_numpy(A),
                    tb(Bb), tb(Cb), torch.from_numpy(s0), chunk=16)
    assert y.dtype == torch.bfloat16
    yj32 = np.asarray(yj.astype(jnp.float32))
    # one bf16 rounding flip at most: 2^-8 of the element
    np.testing.assert_allclose(y.float().numpy(), yj32, rtol=8e-3,
                               atol=1e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **CHUNKED)


# ---------------------------------------------------------------------------
# The fused scan of one chunk, and the plan that routes to it.
# ---------------------------------------------------------------------------

BF16_Y = dict(rtol=8e-3, atol=1e-2)      # one bf16 rounding flip at most


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [
    # (B, S, H, P, G, N, pad, init); nc = 1
    (3, 16, 8, 16, 4, 16, 5, True),
    (2, 64, 8, 16, 1, 16, 0, True),
    (2, 32, 4, 16, 2, 16, 7, False),
    (1, 1, 8, 16, 1, 16, 0, True),
], ids=lambda d: "B{}S{}H{}P{}G{}N{}pad{}{}".format(
    *d[:7], "init" if d[7] else ""))
def test_fused_plain_version_matches_jax(dims, dtype):
    """ssd_scan_fused_ref against the JAX package's two Pallas kernels
    (interpret mode) with its state passing between them, and against the
    JAX op's jnp backend, at one chunk."""
    B, S, H, P, G, N, pad, init = dims
    x, dt, A, Bm, Cm, s0 = _inputs(sum(dims[:7]), B, S, H, P, G, N, pad,
                                   init=True)
    if not init:
        s0 = np.zeros_like(s0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, bj, cj = (jnp.asarray(a, jdt) for a in (x, Bm, Cm))
    # the port's bf16 operands hold exactly the JAX package's bf16 values
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype))
    y, fin = ssd_scan_fused_ref(tt(xj), torch.from_numpy(dt),
                                torch.from_numpy(A), tt(bj), tt(cj),
                                torch.from_numpy(s0), chunk=S)
    assert y.dtype == getattr(torch, dtype) and y.shape == (B, S, H, P)
    yi, st, ce = ssd_chunk_pallas(xj, jnp.asarray(dt), jnp.asarray(A), bj,
                                  cj, chunk=S, interpret=True)
    s_in, jfin = j_state_passing(st, ce[:, :, -1, :], jnp.asarray(s0))
    yp = ssd_apply_pallas(yi, cj.reshape(B, 1, S, G, N), ce, s_in,
                          interpret=True).reshape(B, S, H, P)
    yk, fk = j_ssd_scan(xj, jnp.asarray(dt), jnp.asarray(A), bj, cj,
                        jnp.asarray(s0), chunk=S, backend="jnp")
    y_tol = CHUNKED if dtype == "float32" else BF16_Y
    for yw, fw in ((yp, jfin), (yk, fk)):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(yw.astype(jnp.float32)),
                                   **y_tol)
        np.testing.assert_allclose(fin.numpy(), np.asarray(fw), **CHUNKED)


def _packed(B, S, H, P, G, N, dtype, extra=0, offset=0):
    """x, B, C as column slices of one (B, S, H*P + 2*G*N + extra)
    activation, starting ``offset`` columns in, as the mamba layer hands
    them to the scan."""
    di, gn = H * P, G * N
    a = torch.zeros((B, S, offset + di + 2 * gn + extra), dtype=dtype)
    a = a[..., offset:]
    return (a[..., :di].reshape(B, S, H, P),
            a[..., di:di + gn].reshape(B, S, G, N),
            a[..., di + gn:di + 2 * gn].reshape(B, S, G, N))


def test_plan_routes_and_stages():
    """The route, variant and staging from dtype, shape, strides and
    alignment: the engine's packed bf16 slices of mamba2-780m (row stride
    3328) at one chunk take the fused launch with 16-byte cp.async; a row
    stride or base that is not 16-byte aligned takes scalar staging on the
    same route; fp32 and N > 128 take the CUDA-core passes; several chunks
    the two tensor-core passes."""
    bf = torch.bfloat16
    x, Bm, Cm = _packed(2, 16, 48, 64, 1, 128, bf)
    assert x.stride()[1] == 3328 and not x.is_contiguous()
    assert plan(x, Bm, Cm, chunk=16) == Plan("fused", "mma", "async")
    assert plan(x, Bm, Cm, chunk=4) == Plan("two_pass", "mma", "async")
    assert apply_plan(x.reshape(2, 4, 4, 48, 64),
                      Cm.reshape(2, 4, 4, 1, 128)) == \
        Plan("two_pass", "mma", "async")
    x, Bm, Cm = _packed(2, 16, 48, 64, 1, 128, bf, extra=3)   # stride 3331
    assert plan(x, Bm, Cm, chunk=16) == Plan("fused", "mma", "scalar")
    x, Bm, Cm = _packed(2, 16, 48, 64, 1, 128, bf, offset=1)  # base + 2 B
    assert plan(x, Bm, Cm, chunk=16) == Plan("fused", "mma", "scalar")
    x, Bm, Cm = _packed(1, 16, 6, 8, 3, 12, bf)               # N % 8 != 0
    assert plan(x, Bm, Cm, chunk=16) == Plan("fused", "mma", "scalar")
    x, Bm, Cm = _packed(2, 16, 48, 64, 1, 128, torch.float32)
    assert plan(x, Bm, Cm, chunk=16) == Plan("two_pass", "simt", "scalar")
    x, Bm, Cm = _packed(1, 16, 4, 16, 1, 160, bf)
    assert plan(x, Bm, Cm, chunk=16) == Plan("two_pass", "simt", "scalar")
    with pytest.raises(ValueError):                  # positions not even
        x, Bm, Cm = _packed(2, 16, 4, 16, 1, 16, bf)
        plan(x.transpose(0, 1).contiguous().transpose(0, 1), Bm, Cm,
             chunk=16)


def test_cpu_route_counts_one_fused_plain_call():
    """On the CPU ssd_scan takes the plain versions of the card's route:
    one fused call for bf16 at one chunk (the same numbers as the two
    passes run by hand), the two passes for fp32 or several chunks."""
    x, dt, A, Bm, Cm, s0 = _inputs(5, 2, 32, 4, 16, 2, 16, pad=4, init=True)
    xb, Bb, Cb = (torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm))
    dt_, A_, s0_ = _t(dt, A, s0)

    def counts():
        return (ssd_scan_fused_ref.launches, ssd_chunk_ref.launches,
                ssd_apply_ref.launches)

    n0 = counts()
    y, fin = ssd_scan(xb, dt_, A_, Bb, Cb, s0_, chunk=32)
    assert counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    yi, st, ce = ssd_chunk_ref(xb, dt_, A_, Bb, Cb, chunk=32)
    s_in, fw = _state_passing(st, ce[:, :, -1, :], s0_)
    yw = ssd_apply_ref(yi, Cb.reshape(2, 1, 32, 2, 16), ce, s_in)
    assert torch.equal(y, yw.reshape(y.shape)) and torch.equal(fin, fw)
    n0 = counts()
    ssd_scan(xb, dt_, A_, Bb, Cb, s0_, chunk=8)               # nc = 4
    ssd_scan(*_t(x, dt, A, Bm, Cm, s0), chunk=32)             # fp32
    assert counts() == (n0[0], n0[1] + 2, n0[2] + 2)
