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
                                          ssd_ref, ssd_scan)

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
