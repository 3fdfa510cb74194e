"""The port's CommandQueue / KernelEvent beside the JAX queue's
(tests/test_hybrid_queue.py).

Each test runs the same assertions on both queues: the JAX queue with a
HybridKernel on the 4x4 grid (``mesh16``), the port's with a named step
body on the CPU, where a built step is the eager body.  The mixed-traffic
test serves the same config and prompts through the JAX engine and the
port's engine (the JAX engine's weights, CPU) and holds both queues'
event records to the same invariants and to each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core.hybrid import CommandQueue as JCommandQueue
from repro.core.hybrid import HybridKernel as JHybridKernel
from repro.core.shmem import ShmemGrid as JShmemGrid
from repro.models.config import ModelConfig as JModelConfig
from repro.models.ref import gather_params
from repro.partition import MODEL
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import SamplingParams as JSamplingParams
from repro.serve.engine import build_engine as j_build_engine
from repro_torch.core import CommandQueue
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve.engine import (EngineConfig, SamplingParams,
                                      build_engine)

QUEUES = ["jax", "torch"]


class _Queue:
    """One queue and its ``addk`` kernel (a + b) behind one face."""

    def __init__(self, kind, mesh):
        if kind == "jax":
            self.queue = JCommandQueue(mesh)
            self.kern = JHybridKernel(
                lambda grid, a, b: a + b, grid=JShmemGrid(MODEL, 4, 4),
                in_specs=(P(MODEL), P(MODEL)), out_specs=P(MODEL),
                name="addk")
            self.args = (jnp.ones((16, 8), jnp.float32),
                         jnp.full((16, 8), 2.0, jnp.float32))
            self.build = lambda: self.queue.build(self.kern, *self.args)
            self.enqueue = lambda: self.queue.enqueue(self.kern, *self.args)
        else:
            self.queue = CommandQueue("cpu")
            self.calls = 0

            def add(a, b):
                self.calls += 1
                return a + b
            self.args = (torch.ones((16, 8)), torch.full((16, 8), 2.0))
            self.build = lambda: self.queue.build("addk", add, *self.args)
            self.enqueue = lambda: self.queue.enqueue("addk", add, *self.args)


@pytest.mark.parametrize("kind", QUEUES)
def test_build_time_stays_cumulative_over_a_rebuild(mesh16, kind):
    """A build stamps ``build_time_s``; a rebuild adds to it and keeps what
    a consumer recorded on the event.  The port's CPU build is the eager
    body: building runs nothing."""
    q = _Queue(kind, mesh16)
    q.build()
    ev = q.queue.events["addk"]
    t1 = ev.build_time_s
    assert t1 > 0.0
    assert q.queue.n_executables == 1
    ev.flops, ev.collective_bytes = 123.5, 3.0
    q.build()
    assert (ev.flops, ev.collective_bytes) == (123.5, 3.0)
    assert ev.build_time_s > t1
    assert q.queue.n_executables == 1
    if kind == "torch":
        assert q.calls == 0


@pytest.mark.parametrize("kind", QUEUES)
def test_enqueue_finish_event_lifecycle(mesh16, kind):
    q = _Queue(kind, mesh16)
    out = q.enqueue()                    # implicit first build
    assert q.queue.depth == 1
    assert q.queue.n_executables == 1
    q.queue.finish()
    assert q.queue.depth == 0
    np.testing.assert_allclose(np.asarray(out), 3.0)
    ev = q.queue.events["addk"]
    assert ev.launches == 1 and ev.build_time_s > 0.0
    assert 0.0 < ev.first_enqueue_t <= ev.last_enqueue_t <= ev.last_done_t
    assert ev.active_span_s >= 0.0


@pytest.mark.parametrize("kind", QUEUES)
def test_max_depth_tracks_inflight_high_water(mesh16, kind):
    """``max_depth`` is the enqueued-but-not-drained high-water mark, not
    the current occupancy — it must survive the drain."""
    q = _Queue(kind, mesh16)
    for _ in range(3):
        q.enqueue()
    assert q.queue.depth == 3 and q.queue.max_depth == 3
    q.queue.finish()
    assert q.queue.depth == 0 and q.queue.max_depth == 3
    q.enqueue()
    q.queue.finish()
    assert q.queue.max_depth == 3        # high-water, not last depth
    assert q.queue.events["addk"].launches == 4
    assert q.queue.n_executables == 1    # built once, launched four times
    if kind == "torch":
        assert q.calls == 4


JCFG = JModelConfig(name="q", family="dense", d_model=64, n_layers=2,
                    n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=128,
                    param_dtype=jnp.float32, compute_dtype=jnp.float32,
                    attn_block_kv=32)
ENGINE = dict(s_max=32, buckets=(1, 2, 4), block_pos_stride=4,
              prefill_chunks=(4, 16))


def _engines(mesh, plan):
    """The JAX engine (seed 0) and the port's engine on its weights."""
    jeng = j_build_engine(JCFG, mesh, plan, engine_cfg=JEngineConfig(**ENGINE),
                          seed=0)
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"param_dtype", "compute_dtype"}
    tcfg = ModelConfig(**{n: getattr(JCFG, n) for n in names},
                       param_dtype=torch.float32, compute_dtype=torch.float32)
    gp = jax.tree.map(np.asarray,
                      gather_params(jeng.params, jeng.specs, 4, 4))
    teng = build_engine(tcfg, params=from_jax_params(gp, tcfg, device="cpu"),
                        engine_cfg=EngineConfig(device="cpu", **ENGINE))
    return {"jax": (jeng, JSamplingParams), "torch": (teng, SamplingParams)}


def test_event_accounting_under_mixed_prefill_decode_traffic(mesh16, plan16):
    """tests/test_hybrid_queue.py's mixed traffic, through both engines:
    staggered submits interleave prefill chunk launches with decode-phase
    slots.  In each engine ``n_executables`` equals the distinct steps
    launched, launches add up to ``stats.steps``, every event was built,
    launched and drained, and the finish()-per-step discipline keeps the
    high-water depth at 1; the two engines launch the same steps the same
    number of times."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, JCFG.vocab_size,
                            size=int(rng.integers(5, 12))).tolist()
               for _ in range(4)]
    launches = {}
    for kind, (eng, sp) in _engines(mesh16, plan16).items():
        eng.submit(prompts[0], sp(max_tokens=10))
        eng.step()
        eng.step()
        for p in prompts[1:]:
            eng.submit(p, sp(max_tokens=4))
        eng.drain()

        events = eng.kernel_events()
        assert events and set(events) == set(eng.queue.events), kind
        assert any(n.startswith("prefill_bs") for n in events)
        assert any(n.startswith("serve_step_bs") for n in events)
        assert eng.queue.n_executables == len(events), kind
        assert sum(ev.launches for ev in events.values()) == eng.stats.steps
        for name, ev in events.items():
            assert ev.launches > 0 and ev.build_time_s > 0.0, (kind, name)
            assert 0.0 < ev.first_enqueue_t <= ev.last_enqueue_t, name
            assert ev.last_done_t >= ev.last_enqueue_t, name
            assert ev.active_span_s == ev.last_done_t - ev.first_enqueue_t \
                > 0.0
        assert eng.queue.max_depth == 1 and eng.queue.depth == 0, kind
        launches[kind] = {n: ev.launches for n, ev in events.items()}
    assert launches["torch"] == launches["jax"]
