"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads:
shapes, input specs, meta parameters and caches, the grouped GEMM's meta
route and cost count, the memory tracker, and chip_smoke.py's bounds.

Held against the JAX package where it has a counterpart:

* ``configs/shapes.py``: ``SHAPES`` and ``applicable`` for every arch x
  shape, equal;
* ``launch/specs.py``: every spec's shape equal to the JAX
  ``ShapeDtypeStruct``'s, dtypes mapped int32 -> torch.int32, float32 ->
  torch.float32;
* ``config_param_bytes`` against the bytes of JAX ``param_specs(cfg, 1,
  1)``, and the meta ``cache_specs`` against JAX ``cache_specs(cfg, plan,
  B, S, mode)`` on a 1x1 plan, for decode_32k and long_500k: equal bytes.

And on its own terms: the 2-and-3-group extrapolation equals a count at
full depth on reduced configs (every count, the peak included, exactly);
the forward's FLOPs at a reduced dense config equal a closed form derived
from the config (attention over every key block, as ``chunked_attention``
computes it) within 1 %; the meta route's grouped-GEMM count equals
``cost.py``'s, the CPU route counts nothing; the tracker gives the same
peak on meta (reusing meta kernels' results) and on the CPU.
Tiny CPU ops run on one thread here (restored after the module).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import applicable as j_applicable
from repro.launch import specs as j_specs
from repro.models import params as pm
from repro.models.transformer import param_specs
from repro.partition import DATA, MODEL, MeshPlan
from repro.serve.decode import cache_specs as j_cache_specs
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.configs.shapes import SHAPES, Shape, applicable
from repro_torch.kernels.grouped_mm import cost, grouped_mm_ref
from repro_torch.launch import dryrun as dr
from repro_torch.launch import specs as sp
from repro_torch.launch.memtrack import MemTracker
from repro_torch.models import layers
from repro_torch.models.moe import moe_block
from repro_torch.models.params import config_param_bytes, init_params
from repro_torch.serve.decode import cache_specs, make_prefill

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}
PLAN_1x1 = MeshPlan((DATA, MODEL), (1, 1), 1, 1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_bytes(tree):
    return sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
               for s in jax.tree.leaves(
                   tree, is_leaf=lambda x: isinstance(x, pm.ParamSpec)))


def _t_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in jax.tree.leaves(tree) if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Shapes, specs, parameters and caches against the JAX package.
# ---------------------------------------------------------------------------

def test_shapes_match_jax():
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in J_SHAPES]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_applicable_and_specs_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert tcfg.sub_quadratic == jcfg.sub_quadratic
    for js, ts in zip(J_SHAPES, SHAPES):
        assert applicable(tcfg, ts) == j_applicable(jcfg, js)
        for j_fn, t_fn in ((j_specs.train_batch_specs, sp.train_batch_specs),
                           (j_specs.prefill_batch_specs,
                            sp.prefill_batch_specs)):
            want, got = j_fn(jcfg, js), t_fn(tcfg, ts)
            assert set(want) == set(got)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (k, ts.name)
                assert got[k].dtype == DTYPES[want[k].dtype.type], k
                assert got[k].is_meta
        want = j_specs.decode_token_specs(jcfg, js)
        got = sp.decode_token_specs(tcfg, ts)
        assert tuple(got.shape) == want.shape and got.dtype == torch.int32
        assert sp.decode_mode(ts) == j_specs.decode_mode(js)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_bytes_match_jax(arch):
    want = _j_bytes(param_specs(j_get_config(arch), 1, 1))
    assert config_param_bytes(get_config(arch)) == want
    meta = init_params(get_config(arch), device="meta")
    assert _t_bytes(meta) == want
    assert all(t.is_meta for t in jax.tree.leaves(meta))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_bytes_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    checked = 0
    for js, ts in zip(J_SHAPES, SHAPES):
        if ts.name not in ("decode_32k", "long_500k") \
                or not applicable(tcfg, ts)[0]:
            continue
        mode = sp.decode_mode(ts)
        want = sum(int(np.prod(s.shape)) * jnp.dtype(s.dtype).itemsize
                   for s in jax.tree.leaves(j_cache_specs(
                       jcfg, PLAN_1x1, js.global_batch, js.seq_len, mode)))
        got = cache_specs(tcfg, ts.global_batch, ts.seq_len, mode,
                          device="meta")
        assert _t_bytes(got) == want, ts.name
        checked += 1
    assert checked == (2 if tcfg.sub_quadratic else 1)


def test_meta_needs_no_generator_and_the_card_still_does():
    with pytest.raises(ValueError, match="generator"):
        init_params(reduced(get_config("qwen2-0.5b")), device="cpu")


# ---------------------------------------------------------------------------
# The extrapolation, the FLOP closed form and the tracker.
# ---------------------------------------------------------------------------

SMALL = {"train": Shape("t", 64, 2, "train"),
         "prefill": Shape("p", 64, 2, "prefill"),
         "decode": Shape("d", 64, 2, "decode"),
         "long_decode": Shape("l", 128, 1, "long_decode")}


@pytest.mark.parametrize("arch,kind", [
    ("qwen2-0.5b", "train"), ("qwen3-moe-235b-a22b", "train"),
    ("mamba2-780m", "prefill"), ("jamba-1.5-large-398b", "decode"),
    ("whisper-base", "train"), ("pixtral-12b", "prefill"),
    ("mamba2-780m", "long_decode")])
def test_extrapolation_equals_full_depth(arch, kind):
    """Every count (FLOPs, the grouped GEMM's, resident, peak) at 5 groups
    from the counts at 2 and 3 groups equals the count at 5 groups."""
    cfg = reduced(get_config(arch))
    if cfg.enc_layers:              # one encoder layer a decoder group
        cfg = dataclasses.replace(cfg, enc_layers=cfg.n_groups())
    shape, opts = SMALL[kind], dr.Options()
    ra, rb = (dr.count_config(cfg, shape, shape.global_batch, g, opts)
              for g in dr.COUNT_GROUPS)
    full = dr.count_config(cfg, shape, shape.global_batch, 5, opts)
    assert dr.extrapolate(ra, rb, 5) == full
    assert full["aten_flops"] > 0 and full["peak"] > full["resident"] > 0
    assert (full["gmm_launches"] > 0) == bool(cfg.n_experts)


def _closed_form_prefill_flops(cfg, B, S):
    """Matmul FLOPs of make_prefill: per layer the q/k/v/o projections,
    attention's scores and weighted sum over all S keys (chunked_attention
    folds every key block, masked ones included), the swiglu MLP; then
    the lm_head on the last position."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd()
    Hq, kvh = cfg.heads_padded(1), cfg.kv_stored(1)[0]
    T = B * S
    per_layer = (2 * T * D * (Hq + 2 * kvh) * hd       # q, k, v
                 + 2 * 2 * B * Hq * S * S * hd        # q k^T, p v
                 + 2 * T * Hq * hd * D                # o
                 + 3 * 2 * T * D * F)                 # gate, up, down
    return cfg.n_layers * per_layer + 2 * B * D * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b"])
def test_forward_flops_match_closed_form(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_block_kv=32)
    B, S = 2, 128                       # 4 key blocks a layer
    params = init_params(cfg, device="meta")
    batch = sp.prefill_batch_specs(cfg, Shape("p", S, B, "prefill"))
    with FlopCounterMode(display=False) as fc:
        make_prefill(cfg)(params, batch)
    want = _closed_form_prefill_flops(cfg, B, S)
    assert abs(fc.get_total_flops() - want) <= 0.01 * want


def test_tracker_same_peak_on_meta_and_cpu():
    """On meta the tracker reuses meta kernels' results (memtrack.py); on
    the CPU every op runs: the same resident and peak bytes."""
    cfg = dr.at_groups(reduced(get_config("qwen3-moe-235b-a22b")), 2)
    shape = SMALL["train"]
    got = []
    for dev in ("meta", "cpu"):
        run, resident = dr.build_cell(cfg, shape, 2, dr.Options(),
                                      device=dev)
        layers._rope_freqs.cache_clear()
        tracker = MemTracker(*resident)
        with tracker:
            out = run()
            del out
        got.append((tracker.resident, tracker.peak))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# The grouped GEMM: meta route, cost count, chip_smoke.py's bounds.
# ---------------------------------------------------------------------------

def test_meta_route_count_equals_cost():
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    D, E, F, k = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, cfg.top_k
    B, S = 2, 16
    M = B * S * k                           # every pair kept at cf >= 1
    p = {"router": torch.empty((D, E), device="meta"),
         "w1": torch.empty((E, D, 2 * F), device="meta", requires_grad=True),
         "w2": torch.empty((E, F, D), device="meta", requires_grad=True)}
    x = torch.empty((B, S, D), device="meta", requires_grad=True)
    with cost.counting() as c:
        y, _ = moe_block(p, x, cfg)
        assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
        y.sum().backward()
    act = min(E, M)
    want = {"swiglu": (1, (M, D, 2 * F)), "forward": (2, None),
            "dgrad": (2, None), "wgrad": (2, None)}
    assert c.launches == {k_: n for k_, (n, _) in want.items()}
    # forward: w2's product, then w1's again in the swiglu backward;
    # dgrad and wgrad: one of each per product
    prods = {"swiglu": [(M, D, 2 * F)],
             "forward": [(M, F, D), (M, D, 2 * F)],
             "dgrad": [(M, F, D), (M, D, 2 * F)],
             "wgrad": [(M, F, D), (M, D, 2 * F)]}
    for kind, shapes in prods.items():
        assert c.flops[kind] == sum(cost.operations(r, K, N)
                                    for r, K, N in shapes)
        assert c.bytes[kind] == 4 * sum(cost.elements(kind, r, K, N, E, act)
                                        for r, K, N in shapes)


def test_cpu_route_counts_nothing_and_runs_the_plain_version():
    x = torch.randn(8, 16)
    w = torch.randn(2, 16, 8)
    off = torch.tensor([0, 3, 8], dtype=torch.int32)
    n0 = grouped_mm_ref.launches
    from repro_torch.kernels.grouped_mm import grouped_mm
    with cost.counting() as c:
        y = grouped_mm(x, w, off)
    assert grouped_mm_ref.launches == n0 + 1 and not y.is_meta
    assert c.total_flops == 0 and sum(c.launches.values()) == 0
    with pytest.raises(ValueError, match="kind"):
        cost.elements("other", 1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_give_the_recorded_figures(chip_smoke):
    """PERF.md §6 rows 6-6c, bound column: w1 decode 0.3909 ms (fused
    0.3908), the training step's dgrad and wgrad 1.668 ms (operations)."""
    E, k = 128, 8
    decode = chip_smoke.routed_offsets(np.random.default_rng(9), 64 // k,
                                       E, k)
    ms, by, active = chip_smoke.gmm_bound(decode, 4096, 3072,
                                          torch.bfloat16)
    assert (round(ms, 4), by, active) == (0.3909, "bytes", 52)
    assert round(chip_smoke.gmm_bound(decode, 4096, 3072, torch.bfloat16,
                                      swiglu=True)[0], 4) == 0.3908
    train = chip_smoke.routed_offsets(np.random.default_rng(0), 65536 // k,
                                      E, k)
    for kind in ("dgrad", "wgrad"):
        ms, by = chip_smoke.grad_bound(kind, train, 4096, 3072,
                                       torch.bfloat16)
        assert (round(ms, 3), by) == (1.668, "operations")


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

MEMORY = 80 * 10 ** 9                    # a card of 80 GB (test figure)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Three full-size cells through main(): one that fits, one that does
    not, one skipped."""
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape in (("mamba2-780m", "long_500k"),
                        ("qwen2-0.5b", "decode_32k"),
                        ("qwen2-0.5b", "long_500k")):
        dr.main(["--arch", arch, "--shape", shape, "--device", "cpu",
                 "--memory-bytes", str(MEMORY), "--out", str(out),
                 "--jobs", "1"])
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


def test_dryrun_writes_one_report_a_cell(cells):
    assert sorted(cells) == ["mamba2-780m__long_500k",
                             "qwen2-0.5b__decode_32k",
                             "qwen2-0.5b__long_500k"]
    skip = cells["qwen2-0.5b__long_500k"]
    assert skip["status"] == "skipped"
    assert skip["reason"] == j_applicable(j_get_config("qwen2-0.5b"),
                                          J_SHAPES[3])[1]
    for tag in ("mamba2-780m__long_500k", "qwen2-0.5b__decode_32k"):
        rep = cells[tag]
        assert rep["status"] == "ok"
        for key in ("flops", "peak_bytes", "fits", "max_layers",
                    "max_batch", "param_bytes", "max_groups"):
            assert key in rep, key
        rf = rep["roofline"]
        assert rf["card"] == dr.ROOFLINE_CARD
        assert rf["compute_s"] == rep["flops"] / 989e12
        assert rf["memory_s"] == rep["resident_bytes"] / 3.35e12
        assert rep["param_bytes"] == config_param_bytes(
            get_config(rep["arch"]))


def test_dryrun_fit_and_depth_agree(cells):
    fits = cells["mamba2-780m__long_500k"]
    assert fits["fits"] and fits["max_layers"] >= fits["n_layers"]
    assert fits["max_batch"] >= fits["batch"]
    # 51.5 GB of cache and the fixed path's fp32 K/V repeat: more than 0.9
    # of 80 GB at batch 128
    big = cells["qwen2-0.5b__decode_32k"]
    assert not big["fits"] and big["peak_bytes"] > 0.9 * MEMORY
    assert big["max_layers"] < big["n_layers"]
    assert 0 < big["max_batch"] < big["batch"]
    assert big["resident_bytes"] == config_param_bytes(
        get_config("qwen2-0.5b")) + 24 * 2 * 128 * 32768 * 2 * 64 * 2 \
        + 128 * 4                       # the weights, the cache, the tokens


def test_port_holds_no_tpu_constant():
    src = (ROOT / "src" / "repro_torch")
    for path in src.rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "50e9"):
            assert const not in text, (path, const)
