"""qwen2-7b and stablelm-12b in the port, against the JAX package.

* The reduced configs (``repro.configs.registry.reduced``: same family,
  layernorm / QKV bias, GQA, tiny dims) served by the JAX engine on the
  4x4 grid and by the port's engine on the CPU from the same weights give
  identical greedy tokens and ``EngineStats`` (fp32).
* The paged-attention plain version at the two configs' full head
  geometries, stablelm-12b's (32 q over 8 kv heads, hd 160: group 4) and
  qwen2-7b's (28 over 4, hd 128: group 7), matches the JAX package's
  ``kernels/paged_attention/ref.py`` at small B and L, in fp32, rel < 1e-5
  after the LSE row merge (the bar the JAX package sets between its own
  two backends).
* The bf16 kernel's planner takes both geometries: group 7 fills 7 of its
  8 warps at a 16-position tile, and hd 160 is one of its head sizes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.kernels.paged_attention import merge_rows as j_merge_rows
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as j_paged_ref
from repro.models.ref import gather_params
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro.serve.engine import generate as j_generate
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import merge_rows, paged_attention
from repro_torch.kernels.paged_attention.kernel import (HEAD_DIMS, TC_ROWS,
                                                        tc_tile_l)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine, generate)

ARCHS = ("qwen2-7b", "stablelm-12b")
TOL = 1e-5
STATS = ("steps", "prefill_launches", "prefill_chunk_launches",
         "decode_launches", "prompt_tokens_ingested", "tokens_generated",
         "migrations", "peak_blocks_used", "prefix_hits")


def torch_config(jcfg) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_engine_matches_jax_engine(mesh16, plan16, arch):
    """Eight mixed-length prompts (some past one chunk), 8 greedy tokens,
    buckets (1, 2, 4), stride 4, chunks (8,): identical tokens and
    counters."""
    jcfg = j_reduced(j_get_config(arch))
    ec = dict(s_max=32, buckets=(1, 2, 4), block_pos_stride=4,
              prefill_chunks=(8,))
    jeng = j_build_engine(jcfg, mesh16, plan16, seed=0,
                          engine_cfg=JEngineConfig(**ec))
    gp = jax.tree.map(np.asarray,
                      gather_params(jeng.params, jeng.specs, 4, 4))
    tcfg = torch_config(jcfg)
    assert (tcfg.norm, tcfg.qkv_bias) == (jcfg.norm, jcfg.qkv_bias)
    teng = build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                        engine_cfg=EngineConfig(device="cpu", **ec))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size,
                            size=int(rng.integers(2, 20))).tolist()
               for _ in range(8)]
    jo = j_generate(jeng, prompts, JSamplingParams(max_tokens=8))
    to = generate(teng, prompts, SamplingParams(max_tokens=8))
    assert [c.tokens for c in to] == [c.tokens for c in jo]
    assert all(c.finish_reason == "length" for c in to)
    assert {k: getattr(teng.stats, k) for k in STATS} \
        == {k: getattr(jeng.stats, k) for k in STATS}


def _case(rng, *, B, T, stride, kvh, hd, Hq, L):
    n_blocks = B * T
    table = rng.permutation(n_blocks).astype(np.int32).reshape(B, T)
    table[0, 1] = -1                         # a hole mid-table
    table[-1, -1] = -1                       # an unallocated tail entry
    kc = rng.normal(size=(n_blocks, stride, kvh, hd)).astype(np.float32)
    vc = rng.normal(size=(n_blocks, stride, kvh, hd)).astype(np.float32)
    q = rng.normal(size=(B, Hq, L, hd)).astype(np.float32)
    pos = rng.integers(0, T * stride - L + 1, size=B).astype(np.int32)
    return table, kc, vc, q, pos[:, None] + np.arange(L, dtype=np.int32)


@pytest.mark.parametrize("L", [1, 5, 16], ids=["decode", "verify", "chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_plain_version_at_full_head_geometry(arch, L):
    cfg = get_config(arch)
    Hq, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    assert (Hq // kvh, hd) == {"qwen2-7b": (7, 128),
                               "stablelm-12b": (4, 160)}[arch]
    rng = np.random.default_rng(hd + L)
    table, kc, vc, q, q_pos = _case(rng, B=2, T=4, stride=16, kvh=kvh,
                                    hd=hd, Hq=Hq, L=L)
    t = torch.from_numpy
    got = merge_rows([paged_attention(t(q), t(kc), t(vc), t(table),
                                      t(q_pos), stride=16)]).numpy()
    want = np.asarray(j_merge_rows([j_paged_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table),
        jnp.asarray(q_pos), stride=16, row=0, qrows=1)]))
    assert np.isfinite(got).all()
    assert np.abs(want - got).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_kernel_plans_the_full_geometry(arch):
    """The bf16 kernel's tile (kernel.py::tc_tile_l, mirrored by the CUDA
    source's make_tc_geometry): at most TC_ROWS = 128 rows, 16 a warp,
    8 warps; a chunk of group 7 takes 16 positions, 112 rows, 7 warps."""
    cfg = get_config(arch)
    group, hd = cfg.n_heads // cfg.n_kv_heads, cfg.hd()
    assert hd in HEAD_DIMS
    for L in (1, 5, 16, 64, 256):
        rows = group * tc_tile_l(group, L)
        assert rows <= TC_ROWS and -(-rows // 16) <= 8
    assert tc_tile_l(group, 256) == 16
