"""repro_torch's MoE block and its grouped GEMM against the JAX package.

* ``moe_block`` against ``repro.models.ref._moe_ref`` (the JAX package's
  dropless single-device MoE) on the same global weights, made with numpy
  from a seed: fp32 rel < 1e-5 (max abs difference over max abs value) for
  the output and the aux metric; bf16 rel < 2e-2 for the output (both
  round the expert products, the silu and the gated product to bf16, in
  another summation order, so one bf16 ulp, 2^-8, moves between them and
  compounds through the second product) and 1e-5 for the aux metric,
  which is computed in fp32 from fp32 router logits.
* The drop rule at ``capacity_factor`` 0.5: ``T*k - cap`` pairs drop, the
  last ones in flat ``(token, k)`` order (the rule of ``moe.py:63-72`` at
  one PE), against a numpy reference.
* ``moe_ffn``, the serving path's block without the metrics, gives
  ``moe_block``'s output bit for bit.
* The int8 wire against the JAX formula (``moe.py:88-94``), bit for bit.
* The MoE configs and their ``reduced()`` siblings against the JAX
  registry's, field by field.
* The plain grouped GEMM against a numpy per-expert loop: empty experts,
  every row in one expert, M not a multiple of any tile, rows past
  ``offsets[E]``; and the CUDA wrapper's variant plan, by dtype and by
  rows an expert.
* The plain fused first product ``grouped_mm_swiglu`` against JAX's
  ``silu(lax.ragged_dot(x, w1, group_sizes)[:, :F].astype(f32))
  .astype(dtype) * [:, F:]`` (``moe.py:116-119``): fp32 rel < 1e-5; bf16
  within one bf16 ulp of each value (both round the fp32 sums, the silu and
  the product to bf16; the sums run in another order, which may move a sum
  by one ulp, and so its output by about one).
* The tensor-map arguments of the grouped operands: x as (K, M, 1), w as
  (N, K, E), 64 x 64 boxes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.registry import reduced
from repro.models.ref import _moe_ref
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.grouped_mm import (grouped_mm, grouped_mm_ref,
                                            grouped_mm_swiglu,
                                            grouped_mm_swiglu_ref)
from repro_torch.kernels.grouped_mm.kernel import (WGMMA_BOX,
                                                   WGMMA_MIN_ROWS, plan,
                                                   route, wgmma_tma_args)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import _int8_wire, moe_block, moe_ffn

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BASE = reduced(get_config("qwen3-moe-235b-a22b"))      # 16 experts, top-2
CONFIGS = {
    "qwen3-moe": BASE,
    # top-8 of 32 as in the full configs' k, no renormalisation
    "top8": dataclasses.replace(BASE, n_experts=32, top_k=8,
                                router_renorm=False),
}
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-30)


def torch_config(jcfg, dtype="float32", **kw) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    fields = {n: getattr(jcfg, n) for n in names}
    fields.update(kw)
    return ModelConfig(**fields, param_dtype=TDT[dtype],
                       compute_dtype=TDT[dtype])


def _leaves(cfg, rng, B=3, S=5):
    """Global MoE leaves and an input, numpy fp32: router (D, E), w1
    (E, D, 2F), w2 (E, F, D) at fan-in D, x (B, S, D)."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    n = lambda *shape: (rng.normal(size=shape) * D ** -0.5).astype(
        np.float32)
    p = {"router": n(D, E), "w1": n(E, D, 2 * F), "w2": n(E, F, D)}
    return p, rng.normal(size=(B, S, D)).astype(np.float32)


def _jax_ref(jcfg, p, x, dtype):
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else JDT[dtype])
          for k, v in p.items()}
    y, aux = jax.jit(_moe_ref, static_argnums=0)(
        jcfg, jp, jnp.asarray(x, JDT[dtype]))
    return np.asarray(y.astype(jnp.float32)), float(aux)


def _port(tcfg, p, x, dtype):
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else TDT[dtype]) for k, v in p.items()}
    y, m = moe_block(tp, torch.from_numpy(x).to(TDT[dtype]), tcfg)
    assert y.dtype == TDT[dtype] and y.shape == x.shape
    return y.float().numpy(), m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_block_matches_jax_reference(name, dtype):
    jcfg = CONFIGS[name]
    p, x = _leaves(jcfg, np.random.default_rng(0))
    want, aux = _jax_ref(jcfg, p, x, dtype)
    got, metrics = _port(torch_config(jcfg, dtype), p, x, dtype)
    assert _rel(want, got) < Y_TOL[dtype]
    assert abs(float(metrics["moe_aux"]) - aux) <= AUX_TOL * abs(aux)
    assert float(metrics["moe_dropped"]) == 0.0      # capacity_factor 2.0


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_is_moe_block_without_metrics(dtype, capacity_factor):
    jcfg = CONFIGS["top8"]
    tcfg = torch_config(jcfg, dtype, capacity_factor=capacity_factor)
    p, x = _leaves(jcfg, np.random.default_rng(4))
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else TDT[dtype]) for k, v in p.items()}
    tx = torch.from_numpy(x).to(TDT[dtype])
    want, _ = moe_block(tp, tx, tcfg)
    got = moe_ffn(tp, tx, tcfg)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_drop_rule_at_half_capacity():
    """cap = ceil(T*k * 0.5): the first cap pairs in flat (token, k) order
    are served, the rest contribute nothing and are counted."""
    jcfg = CONFIGS["qwen3-moe"]
    tcfg = torch_config(jcfg, capacity_factor=0.5)
    p, x = _leaves(jcfg, np.random.default_rng(1), B=2, S=7)
    got, metrics = _port(tcfg, p, x, "float32")
    T, k, D = 14, tcfg.top_k, tcfg.d_model
    cap = int(np.ceil(T * k * 0.5))
    assert float(metrics["moe_dropped"]) == (T * k - cap) / (T * k)
    # numpy reference: route, keep flat pairs [0, cap), combine in order
    x2 = x.reshape(T, D).astype(np.float64)
    logits = x2 @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, -1, kind="stable")[:, :k]
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w /= top_w.sum(-1, keepdims=True)
    F = tcfg.d_ff_expert
    want = np.zeros((T, D))
    n_served = 0
    for t in range(T):
        for j in range(k):
            if t * k + j >= cap:
                continue
            e = top_e[t, j]
            h = x2[t] @ p["w1"][e]
            g = h[:F] / (1 + np.exp(-h[:F])) * h[F:]
            want[t] += top_w[t, j] * (g @ p["w2"][e])
            n_served += 1
    assert n_served == cap
    assert _rel(want, got.reshape(T, D)) < 1e-5
    # tokens whose every pair dropped get exactly zero
    n_gone = (T * k - cap) // k
    assert n_gone > 0 and not got.reshape(T, D)[T - n_gone:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_wire_is_the_jax_formula(dtype):
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(24, 64)) * rng.uniform(0.01, 10, (24, 1))
         ).astype(np.float32)
    a[3] = 0.0                                       # an all-zero row
    t = torch.from_numpy(a).to(TDT[dtype])
    j = jnp.asarray(np.asarray(t.float()), JDT[dtype])
    sc = jnp.max(jnp.abs(j.astype(jnp.float32)), axis=-1,
                 keepdims=True) / 127.0 + 1e-12
    q8 = jnp.clip(jnp.round(j.astype(jnp.float32) / sc),
                  -127, 127).astype(jnp.int8)
    want = np.asarray((q8.astype(jnp.float32) * sc).astype(j.dtype)
                      .astype(jnp.float32))
    got = _int8_wire(t)
    assert got.dtype == t.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_wire_rounds_the_moe_block():
    """With ``moe_wire_dtype="int8"`` the block rounds what it sends: the
    output moves from the native block's, by no more than the two
    roundings can move it (each at most half a step of max|row| / 127)."""
    jcfg = CONFIGS["qwen3-moe"]
    p, x = _leaves(jcfg, np.random.default_rng(3))
    native, _ = _port(torch_config(jcfg), p, x, "float32")
    wire, _ = _port(torch_config(jcfg, moe_wire_dtype="int8"), p, x,
                    "float32")
    rel = _rel(native, wire)
    assert 0 < rel < 0.1


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "kimi-k2-1t-a32b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_configs_match_the_jax_registry(name):
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for jcfg, tcfg in ((get_config(name), t_get_config(name)),
                       (reduced(get_config(name)),
                        t_reduced(t_get_config(name)))):
        for f in dataclasses.fields(ModelConfig):
            want = getattr(jcfg, f.name)
            if f.name in ("param_dtype", "compute_dtype"):
                want = dtypes[want]
            assert getattr(tcfg, f.name) == want, (name, f.name)
        assert tcfg.pattern() == jcfg.pattern()
        assert tcfg.n_experts and "moe" in [f for _, f in tcfg.pattern()]


# ---------------------------------------------------------------------------
# The plain grouped GEMM.
# ---------------------------------------------------------------------------

def _np_grouped(x, w, offsets):
    out = np.zeros((x.shape[0], w.shape[2]), np.float64)
    for e in range(w.shape[0]):
        lo, hi = offsets[e], offsets[e + 1]
        out[lo:hi] = x[lo:hi].astype(np.float64) @ w[e]
    return out


GMM_CASES = {
    # name: (M, K, N, E, group sizes, rows past offsets[E])
    "ragged": (37, 24, 40, 6, [5, 0, 17, 0, 9, 6], 0),
    "one_expert": (29, 16, 8, 4, [0, 0, 29, 0], 0),
    "empty_all": (9, 8, 16, 3, [0, 0, 0], 9),
    "sentinel_tail": (50, 32, 24, 5, [3, 11, 0, 20, 4], 12),
    "decode_like": (64, 64, 72, 16, None, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_mm_plain_matches_numpy(case, dtype):
    M, K, N, E, sizes, tail = GMM_CASES[case]
    rng = np.random.default_rng(4)
    if sizes is None:                      # random routing, no tail
        sizes = np.bincount(rng.integers(0, E, M), minlength=E).tolist()
    assert sum(sizes) + tail == M
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    tx = torch.from_numpy(x).to(TDT[dtype])
    tw = torch.from_numpy(w).to(TDT[dtype])
    before = grouped_mm_ref.launches
    got = grouped_mm(tx, tw, torch.from_numpy(offsets))
    assert grouped_mm_ref.launches == before + 1
    assert got.dtype == tx.dtype and got.shape == (M, N)
    want = _np_grouped(tx.double().numpy(), tw.double().numpy(), offsets)
    # one rounding to the output dtype of an fp32 sum
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    assert _rel(want, got.double().numpy()) < tol
    assert not got[offsets[-1]:].any()


def test_grouped_mm_plan():
    x32, w32 = torch.zeros(4, 12), torch.zeros(2, 12, 20)
    assert plan(x32, w32) == "simt"               # fp32 takes any K, N
    bf = torch.bfloat16
    assert plan(x32.to(bf)[:, :8], w32.to(bf)[:, :8, :16]) == "mma"
    with pytest.raises(ValueError, match="multiples of 8"):
        plan(x32.to(bf), w32.to(bf))
    with pytest.raises(TypeError):
        plan(x32, w32.to(bf))
    # bf16 by shape alone: wgmma_tma from WGMMA_MIN_ROWS rows an expert on
    # average, mma below; the epilogue changes only what N must divide
    E = 128
    x = torch.zeros(WGMMA_MIN_ROWS * E, 16, dtype=bf)
    w = torch.zeros(E, 16, 32, dtype=bf)
    assert plan(x, w) == plan(x, w, swiglu=True) == "wgmma_tma"
    assert plan(x[:-1], w) == plan(x[:-1], w, swiglu=True) == "mma"
    assert plan(x.float(), w.float(), swiglu=True) == "simt"
    with pytest.raises(ValueError, match="multiples of 8"):
        plan(x, w[:, :, :24], swiglu=True)        # N of 16 with swiglu
    with pytest.raises(ValueError):
        plan(x.float(), w.float()[:, :, :7], swiglu=True)   # fp32: odd N
    with pytest.raises(TypeError):
        route(torch.float16, 64, 16, 16, 4)


# M = T * k rows of qwen3-moe (E 128, top-8) at batch 8, and the variant
# the prefill chunks take
@pytest.mark.parametrize("stage, M, variant", [
    ("decode", 64, "mma"), ("verify", 320, "mma"), ("len16", 1024, "mma"),
    ("len64", 4096, "wgmma_tma"), ("len256", 16384, "wgmma_tma"),
    ("len256 at batch 1", 2048, "wgmma_tma"),
])
@pytest.mark.parametrize("prod, K, N", [("w1", 4096, 3072),
                                        ("w2", 1536, 4096)])
def test_grouped_mm_plan_at_qwen3_moe_shapes(stage, M, variant, prod, K, N):
    assert route(torch.bfloat16, M, K, N, 128) == variant
    if prod == "w1":
        assert route(torch.bfloat16, M, K, N, 128, swiglu=True) == variant
    assert route(torch.float32, M, K, N, 128) == "simt"


def test_grouped_mm_tma_args():
    """x (M, K) as a (K, M, 1) map and w (E, K, N) as (N, K, E), bf16 byte
    strides of rows and batches, 64 x 64 boxes; TMA cannot read rows that
    are not multiples of 16 bytes."""
    M, K, N, E = 16384, 4096, 3072, 128
    args = wgmma_tma_args(M, K, N, E)
    assert WGMMA_BOX == (64, 64, 1)
    assert args[:8] == (K, M, 1, 2 * K, 2 * K * M, 64, 64, 1)
    assert args[8:] == (N, K, E, 2 * N, 2 * K * N, 64, 64, 1)
    assert wgmma_tma_args(1, 8, 16, 1)[:5] == (8, 1, 1, 16, 16)
    with pytest.raises(ValueError, match="TMA"):
        wgmma_tma_args(64, 12, 16, 2)


SWIGLU_CASES = {
    # name: (M, K, 2F, E, group sizes, rows past offsets[E])
    "ragged": (37, 24, 48, 6, [5, 0, 17, 0, 9, 6], 0),
    "one_expert": (29, 16, 16, 4, [0, 0, 29, 0], 0),
    "sentinel_tail": (50, 32, 40, 5, [3, 11, 0, 20, 4], 12),
    "top8": (96, 64, 64, 16, None, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SWIGLU_CASES))
def test_grouped_mm_swiglu_plain_matches_jax(case, dtype):
    M, K, N, E, sizes, tail = SWIGLU_CASES[case]
    rng = np.random.default_rng(5)
    if sizes is None:                      # top-8 routing, no tail
        picks = np.argsort(rng.random((M // 8, E)), axis=1)[:, :8]
        sizes = np.bincount(picks.ravel(), minlength=E).tolist()
    assert sum(sizes) + tail == M
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(E, K, N)) * K ** -0.5).astype(np.float32)
    F = N // 2
    jx, jw = jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype])
    h = jax.lax.ragged_dot(jx, jw, jnp.asarray(sizes, jnp.int32))
    want = jax.nn.silu(h[:, :F].astype(jnp.float32)).astype(h.dtype) \
        * h[:, F:]
    want = np.asarray(want.astype(jnp.float32), np.float64)
    before = grouped_mm_swiglu_ref.launches
    got = grouped_mm_swiglu(torch.from_numpy(x).to(TDT[dtype]),
                            torch.from_numpy(w).to(TDT[dtype]),
                            torch.from_numpy(offsets))
    assert grouped_mm_swiglu_ref.launches == before + 1
    assert got.dtype == TDT[dtype] and got.shape == (M, F)
    got = got.double().numpy()
    if dtype == "float32":
        assert _rel(want, got) < 1e-5
    else:
        # one bf16 ulp of each value: 2^(e - 7) for |v| in [2^e, 2^(e+1))
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(want - got) <= ulp).all()
    assert not got[offsets[-1]:].any()
