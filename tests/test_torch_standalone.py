"""repro_torch stands alone: no JAX, no ``repro``, the card by default.

The port imports ``torch`` and numpy only; importing ``repro`` would
install JAX shims, and ``repro.serve`` pulls in JAX itself.  Its entry
points run on ``cuda`` unless the caller asks for the CPU, and raise
rather than fall back when there is no card.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.params import config_param_bytes
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      ServingEngine, generate)

PKG = pathlib.Path(repro_torch.__file__).parent


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = [name for _, name in _modules()]
    assert {"repro_torch.serve.spec.decoder",
            "repro_torch.serve.spec.drafter",
            "repro_torch.serve.service.service",
            "repro_torch.serve.resilience.guard",
            "repro_torch.models.transformer",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.train.step", "repro_torch.data.pipeline",
            "repro_torch.ckpt.checkpoint",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.launch.train", "repro_torch.tree",
            "repro_torch.launch.fresh_thread",
            "repro_torch.configs.whisper_base",
            "repro_torch.configs.pixtral_12b",
            "repro_torch.partition", "repro_torch.core.pe_grid",
            "repro_torch.runtime.pe", "repro_torch.kernels.shmem_heap.kernel",
            "repro_torch.kernels.shmem_heap.ref",
            "repro_torch.serve.engine.grid", "repro_torch.models.moe",
            "repro_torch.launch.grid_run", "repro_torch.core.cannon",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.ssm", "repro_torch.serve.state",
            "repro_torch.serve.engine.state_store"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr


def _assert_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_no_source_file_imports_jax_or_repro():
    for path, _ in _modules():
        _assert_no_jax_or_repro_import(path)


def test_chip_smoke_imports_no_jax_or_repro():
    """The chip smoke drives the port on a machine without JAX: it imports
    repro_torch only, never the JAX package."""
    _assert_no_jax_or_repro_import(PKG.parents[1] / "chip_smoke.py")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(reduced(get_config("qwen2-0.5b")))


def test_cpu_only_when_asked():
    assert resolve_device("cpu").type == "cpu"
    cfg = reduced(get_config("qwen2-0.5b"))
    eng = ServingEngine(cfg, engine_cfg=EngineConfig(
        s_max=32, buckets=(1, 2), block_pos_stride=4, device="cpu"))
    assert all(t.device.type == "cpu" for e in eng.store.arena
               for t in e.values())
    outs = generate(eng, [[1, 2, 3], [4, 5, 6, 7, 8]],
                    SamplingParams(max_tokens=3))
    assert [len(c.tokens) for c in outs] == [3, 3]


def test_later_slices_raise_not_implemented(monkeypatch):
    """No slice is left: whisper-base and pixtral-12b, the last names in
    ``LATER``, resolve now.  A name put in ``LATER`` still raises naming
    its slice."""
    from repro_torch import configs
    assert configs.LATER == {}
    assert get_config("whisper-base").family == "encdec"
    assert get_config("pixtral-12b").family == "vlm"
    monkeypatch.setitem(configs.LATER, "qwen2-0.5b", "a later slice")
    with pytest.raises(NotImplementedError, match="slice"):
        get_config("qwen2-0.5b")


@pytest.mark.parametrize("name,widths,gb", [
    ("qwen2-7b", (28, 3584, 28, 4, 128, 18944, 152064), 15.2),
    ("stablelm-12b", (40, 5120, 32, 8, 160, 13824, 100352), 24.3)])
def test_dense_configs_resolve_at_full_width(name, widths, gb):
    """The two dense configs that left LATER: their published widths, bf16
    weights that fit one 80 GB card, and their reduced siblings serve."""
    cfg = get_config(name)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd(), cfg.d_ff, cfg.vocab_size) == widths
    assert cfg.family == "dense" and cfg.param_dtype == torch.bfloat16
    assert round(config_param_bytes(cfg) / 1e9, 1) == gb
    eng = ServingEngine(reduced(cfg), engine_cfg=EngineConfig(
        s_max=32, buckets=(1, 2), block_pos_stride=4, device="cpu"))
    outs = generate(eng, [[1, 2, 3], list(range(4, 15))],
                    SamplingParams(max_tokens=3))
    assert [len(c.tokens) for c in outs] == [3, 3]


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "kimi-k2-1t-a32b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_archs_resolve_and_serve_reduced_on_the_cpu(name):
    cfg = get_config(name)
    assert cfg.n_experts and cfg.top_k and "moe" in [
        f for _, f in cfg.pattern()]
    eng = ServingEngine(reduced(cfg), engine_cfg=EngineConfig(
        s_max=32, buckets=(1, 2), block_pos_stride=4, prefill_chunks=(8,),
        device="cpu"))
    outs = generate(eng, [[1, 2, 3], list(range(4, 15))],
                    SamplingParams(max_tokens=3))
    assert [len(c.tokens) for c in outs] == [3, 3]


def test_pe_grid_on_the_card_needs_cuda():
    """A grid of PE processes runs on the card unless asked for the CPU,
    and raises before it spawns anything when there is no card."""
    from repro_torch.core.pe_grid import probe_collectives
    from repro_torch.partition import grid_plan
    from repro_torch.runtime.pe import run_pes
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pes(probe_collectives, grid_plan(2, 2), args=({},))


def test_one_by_one_plan_is_the_one_device_engine():
    """A 1x1 plan spawns nothing, reserves no heap, and serves the one-device
    engine's tokens; its queue would capture on the card."""
    from repro_torch.partition import grid_plan
    cfg = reduced(get_config("qwen2-0.5b"))
    ec = EngineConfig(s_max=32, buckets=(1, 2), block_pos_stride=4,
                      device="cpu")
    prompts = [[1, 2, 3], list(range(4, 15))]
    outs = []
    for plan in (None, grid_plan(1, 1)):
        eng = ServingEngine(cfg, engine_cfg=ec, plan=plan)
        assert eng.grid is None and eng.pctx is None
        assert eng.heap_bytes == 0 and eng.queue.eager_reason is None
        outs.append([c.tokens for c in generate(
            eng, prompts, SamplingParams(max_tokens=4))])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["mamba2-780m", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
def test_grid_serves_every_decoder_family(name):
    """A grid engine refuses speculation and the step guard only: SSM,
    hybrid and MoE models serve there, and their state specs and weights
    cut into a 2x2 grid's (mamba slots by column, experts by PE)."""
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.partition import grid_plan
    from repro_torch.serve.spec import SpeculationConfig
    from repro_torch.serve.state import layer_state_specs
    cfg = reduced(get_config(name))
    plan = grid_plan(2, 2)
    ServingEngine._refuse_on_grid(cfg, EngineConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="one device"):
        ServingEngine._refuse_on_grid(cfg, EngineConfig(
            device="cpu", speculation=SpeculationConfig("ngram", k=2)))
    one = layer_state_specs(cfg, stride=4)
    grid = layer_state_specs(cfg, plan, stride=4)
    assert grid.dense_slot_bytes() == one.dense_slot_bytes() * 2
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    blk = shard_params(params, cfg, plan, 3)
    for lp, bp in zip(params["layers"], blk["layers"]):
        if "w1" in lp.get("ffn", {}):
            E = cfg.n_experts
            assert torch.equal(bp["ffn"]["w1"],
                               lp["ffn"]["w1"][:, 3 * E // 4:])
        if "wx" in lp["mixer"]:
            assert bp["mixer"]["wx"].shape[-1] * 2 == \
                lp["mixer"]["wx"].shape[-1]
            assert torch.equal(bp["mixer"]["A"], lp["mixer"]["A"])
