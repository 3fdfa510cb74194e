"""The pieces of the blocked layout on a 2x2 grid of PE processes: the four
distributed GEMMs, the weight storage modes, the sequence-sharded mamba
block and the SSD scan it calls.

  * Cannon (pre-skewed B, B skewed by a put, A already skewed), the
    C-rotating Cannon in fp32 and bf16, allgather and SUMMA on
    ``PeGrid`` (four CPU PE processes, ``core/cannon.py::probe_gemms``)
    against ``repro.core.cannon``'s under ``shard_map`` on 4 host devices,
    on the same seeded blocks: fp32 within rel 1e-6; the bf16 crot, whose
    accumulator is rounded to bf16 at every hop, within one bf16 ulp of
    JAX's, and not the once-rounded fp32 product (so the per-hop rounding
    is what matches).
  * ``shard_params(storage=True | "opt" | False)``: every PE's blocks
    exactly the JAX ``init_params`` blocks of ``param_specs(cfg, 2, 2,
    preskew=...)`` (drawn with numpy, gathered to the global tree and cut
    again), for the dense, moe, ssm and hybrid configs of
    tests/test_model_equivalence.py.
  * The sequence-sharded ``mamba_block`` (ssd_chunk 16, two chunks a row,
    the halo and the state relay between the rows) under cannon and
    cannon_opt against the port's block on the whole sequence (1x1),
    within rel 1e-5; and with the last row's positions scaled by 1000,
    row 0's output equal to the block run on row 0's positions alone: the
    halo row 0 receives comes from row q-1 and must be zeroed.
  * The SSD scan op's plain versions against ``ssd_scan_differentiable``
    at several chunk lengths, fp32 and bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core import cannon as jc
from repro.core.shmem import ShmemGrid
from repro.models import params as pm
from repro.models.ref import gather_params
from repro.models.transformer import param_specs
from repro.partition import MODEL
from repro_torch.core.cannon import probe_gemms
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.grid_run import probe_mamba_blocks
from repro_torch.models.params import from_jax_params, shard_params
from repro_torch.models.ssm import mamba_block, ssd_scan_differentiable
from repro_torch.models.transformer import layer_params
from repro_torch.runtime.pe import run_pes

from test_model_equivalence import CFGS
from test_torch_decode_fixed import torch_config
from test_torch_grid_forward import PLAN, init_varied, jax_mesh, rel

Q = R = 2
M, K, N = 6, 16, 12            # global K and N; M rows a PE


def _gemm_inputs():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((K, N)).astype(np.float32)
    a = rng.standard_normal((Q * R, M, K // R)).astype(np.float32)
    blocks = {sk: np.asarray(jc.block_2d(jnp.asarray(w), Q, R, skew_b=sk))
              for sk in (False, True, "crot")}
    return {"a": a, "b": blocks[False], "b_skew": blocks[True],
            "b_crot": blocks["crot"], "a16": _bf16_values(a),
            "b_crot16": _bf16_values(blocks["crot"])}


def _bf16_values(a):
    """fp32 values that bf16 holds exactly (a rounded to bf16)."""
    import ml_dtypes
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _jax_gemms(inputs):
    grid = ShmemGrid(MODEL, Q, R)

    def body(a, b, bs, bc, a16, bc16):
        a, b, bs, bc, a16, bc16 = (t[0] for t in (a, b, bs, bc, a16, bc16))
        out = {
            "cannon": jc.cannon_matmul(grid, a, bs, preskewed_b=True),
            "cannon_skew_b": jc.cannon_matmul(grid, a, b),
            "cannon_arot": jc.cannon_matmul(grid, a, bs, preskewed_b=True,
                                            a_preskewed=True),
            "crot": jc.cannon_matmul_crot(grid, a, bc),
            "crot_bf16": jc.cannon_matmul_crot(grid, a16, bc16),
            "allgather": jc.allgather_matmul(grid, a, b),
            "summa": jc.summa_matmul(grid, a, b),
        }
        return {k: v.astype(jnp.float32)[None] for k, v in out.items()}

    names = ("a", "b", "b_skew", "b_crot", "a16", "b_crot16")
    fn = jax.jit(jax.shard_map(body, mesh=jax_mesh(),
                               in_specs=(P(MODEL),) * len(names),
                               out_specs=P(MODEL), check_vma=False))
    out = fn(*(jnp.asarray(inputs[n], jnp.bfloat16 if n.endswith("16")
                           else jnp.float32) for n in names))
    return {k: np.asarray(v) for k, v in out.items()}


MAMBA = {name: torch_config(dataclasses.replace(CFGS[name], ssd_chunk=16))
         for name in ("ssm", "hybrid")}
MAMBA_CASES = [(n, s) for n in MAMBA for s in ("cannon", "cannon_opt")]


def _mamba_weights(name):
    jcfg = dataclasses.replace(CFGS[name], ssd_chunk=16)
    specs = param_specs(jcfg, 1, 1, preskew=False)
    return jax.tree.map(np.asarray,
                        gather_params(init_varied(specs, seed=3), specs, 1, 1))


def _mamba_x(cfg, seed, tail=1.0):
    x = np.random.default_rng(seed).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    x[:, 32:] *= tail
    return x


def _one_device(cfg, weights, x):
    params = from_jax_params(weights, cfg, device="cpu")
    pos = [m for m, _ in cfg.pattern()].index("mamba")
    p = layer_params(params["layers"][pos], 0)["mixer"]
    with torch.no_grad():
        return mamba_block(p, torch.from_numpy(x), cfg).numpy()


def _blocks_back(outs, strategy, S, D):
    """The natural (B, S, D) from every PE's output block (skewed under
    cannon_opt: PE (i, j) holds feature block (i + j) % q)."""
    s_loc, d_loc = S // Q, D // R
    y = np.zeros((outs[0].shape[0], S, D), np.float32)
    for pe, blk in enumerate(outs):
        i, j = divmod(pe, R)
        f = (i + j) % Q if strategy == "cannon_opt" else j
        y[:, i * s_loc:(i + 1) * s_loc, f * d_loc:(f + 1) * d_loc] = blk
    return y


@pytest.fixture(scope="module")
def runs():
    """Every PE job of the file in one spawn per target."""
    inputs = _gemm_inputs()
    gemms = run_pes(probe_gemms, PLAN, args=(inputs,), device="cpu",
                    timeout=60)
    keys, cases = [], []
    for name, strategy in MAMBA_CASES:
        cfg, w = MAMBA[name], _mamba_weights(name)
        for tail in (1.0, 1000.0):
            keys.append((name, strategy, tail))
            cases.append((cfg, w, _mamba_x(cfg, 4, tail), strategy))
    per_pe = run_pes(probe_mamba_blocks, PLAN, args=(cases,), device="cpu",
                     timeout=60)
    mamba = {k: (c[2], c[1], [per_pe[pe][n] for pe in range(Q * R)])
             for n, (k, c) in enumerate(zip(keys, cases))}
    return inputs, gemms, mamba


GEMMS = ("cannon", "cannon_skew_b", "cannon_arot", "crot", "allgather",
         "summa")


@pytest.fixture(scope="module")
def jax_gemms(runs):
    return _jax_gemms(runs[0])


@pytest.mark.parametrize("op", GEMMS)
def test_gemm_matches_jax(runs, jax_gemms, op):
    _, got, _ = runs
    for pe in range(Q * R):
        assert got[pe][op].shape == jax_gemms[op][pe].shape
        assert rel(jax_gemms[op][pe], got[pe][op]) < 1e-6, (op, pe)


def _once_rounded(inputs, pe):
    """PE ``pe``'s crot output with a single rounding to bf16: its row's
    bf16 A panel times the global bf16 weight's column block (i + j) % q,
    in fp32."""
    i, j = divmod(pe, R)
    a = np.concatenate([inputs["a16"][i * R + c] for c in range(R)], -1)
    w = np.asarray(jc.unblock_2d(jnp.asarray(inputs["b_crot16"]), Q, R,
                                 skew_b="crot"))
    nb, col = N // R, (i + j) % Q
    return _bf16_values(a @ w[:, col * nb:(col + 1) * nb])


def test_crot_bf16_rounds_at_every_hop(runs, jax_gemms):
    inputs, got, _ = runs
    differs = False
    for pe in range(Q * R):
        w, g = jax_gemms["crot_bf16"][pe], got[pe]["crot_bf16"]
        ulp = np.ldexp(1.0, np.frexp(w)[1] - 8)     # bf16 spacing at w
        assert np.all(np.abs(g - w) <= ulp), pe
        differs |= not np.array_equal(w, _once_rounded(inputs, pe))
    assert differs, "the per-hop rounding never changed a value"


@pytest.mark.parametrize("storage", [True, "opt", False],
                         ids=["preskew", "opt", "natural"])
@pytest.mark.parametrize("name", ["dense", "moe", "ssm", "hybrid"])
def test_shard_params_blocks_equal_jax(name, storage):
    jcfg = CFGS[name]
    specs = param_specs(jcfg, Q, R, preskew=storage)
    host = jax.tree.map(np.asarray, init_varied(specs, seed=1))
    gp = jax.tree.map(np.asarray, gather_params(host, specs, Q, R))
    full = from_jax_params(gp, torch_config(jcfg), device="cpu")
    leaves, _ = jax.tree.flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, pm.ParamSpec))
    for pe in range(Q * R):
        blocks = shard_params(full, torch_config(jcfg), PLAN, pe,
                              storage=storage)
        for path, spec in leaves:
            keys = [getattr(k, "key", getattr(k, "idx", None))
                    for k in path]
            want, got = host, blocks
            for key in keys:
                want, got = want[key], got[key]
            got = got.numpy()
            layout = dict(spec.meta).get("layout", "replicated")
            if layout == "replicated":
                np.testing.assert_array_equal(got, want, err_msg=str(keys))
                continue
            stacked = want.ndim == {"blocked2d": 3, "vocab2d": 3,
                                    "expert_flat": 4}[layout] + 1
            np.testing.assert_array_equal(
                got, want[:, pe] if stacked else want[pe],
                err_msg=f"{name} {storage} PE {pe} {keys}")


@pytest.mark.parametrize("case", MAMBA_CASES, ids=lambda c: "-".join(c))
def test_sequence_sharded_mamba_block_matches_one_device(runs, case):
    _, _, mamba = runs
    cfg = MAMBA[case[0]]
    x, w, outs = mamba[case + (1.0,)]
    want = _one_device(cfg, w, x)
    got = _blocks_back(outs, case[1], x.shape[1], x.shape[2])
    assert rel(want, got) < 1e-5


@pytest.mark.parametrize("case", MAMBA_CASES, ids=lambda c: "-".join(c))
def test_row_q_minus_1_tail_does_not_reach_row_0(runs, case):
    _, _, mamba = runs
    cfg = MAMBA[case[0]]
    x, w, outs = mamba[case + (1000.0,)]
    want = _one_device(cfg, w, np.ascontiguousarray(x[:, :32]))
    got = _blocks_back(outs, case[1], x.shape[1], x.shape[2])[:, :32]
    assert rel(want, got) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_scan_plain_matches_differentiable(chunk, dtype):
    g = torch.Generator().manual_seed(chunk)
    B, S, H, Pd, G, Nst = 2, 64, 4, 8, 2, 16
    x = torch.randn(B, S, H, Pd, generator=g).to(dtype)
    dt = torch.rand(B, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    Bm = torch.randn(B, S, G, Nst, generator=g).to(dtype)
    Cm = torch.randn(B, S, G, Nst, generator=g).to(dtype)
    y1, s1 = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y2, s2 = ssd_scan_differentiable(x, dt, A, Bm, Cm, chunk=chunk)
    assert y1.dtype == y2.dtype == dtype
    assert rel(y2.float().numpy(), y1.float().numpy()) < 1e-5
    assert rel(s2.numpy(), s1.numpy()) < 1e-5
