"""The dense-slot command log of a grid controller, and ``drain`` with
arrivals, on one CPU engine.

On a grid PE 0's store logs every operation on its dense slots for the
other PEs (``serve/engine/state_store.py``): a follower that applies the
log reads a host snapshot where PE 0 reads one and drops it where PE 0
lets its copy go.  Here a one-device engine keeps that log (its
``store.commands`` set, as the engine sets it on PE 0) through FIFO and
radix-tree eviction of prefix snapshots, a snapshot published again, and a
preempted request's snapshot restored or ended by a cancel; after every
step the snapshots the log leaves alive must be exactly those PE 0 still
holds, and a store that applies the log must hold the same.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.registry import reduced
from repro_torch.serve.engine import EngineConfig, SamplingParams, \
    build_engine
from repro_torch.serve.engine.state_store import DROP, READ

from test_torch_engine_state import HYBRID, torch_config

S_MAX = 32
CONFIGS = {"ssm": reduced(get_config("mamba2-780m")), "hybrid": HYBRID}


def _engine(family, cap=1, **kw):
    eng = build_engine(torch_config(CONFIGS[family]), seed=0,
                       engine_cfg=EngineConfig(
                           s_max=S_MAX, buckets=(1, 2), block_pos_stride=4,
                           prefill_chunks=(8,), device="cpu", **kw))
    eng.store.commands = []
    eng.store.MAX_PREFIX_SNAPSHOTS = cap
    return eng


def _held(eng):
    """The numbers of the snapshots PE 0's store still holds."""
    st = eng.store
    snaps = list(st._prefix.values())
    if st._tree is not None:
        snaps += [n.dense_snap for n in st._tree._claims.values()
                  if n.dense_snap is not None]
    snaps += [r.dense_snapshot[1] for r in
              list(eng.scheduler.waiting) + list(eng.scheduler.running)
              if r.dense_snapshot is not None]
    return {s.sid for s in snaps}


def _alive(commands):
    """The snapshots a follower applying ``commands`` holds (a drop of a
    snapshot it does not hold raises)."""
    live = set()
    for op, a, b in commands:
        if op == READ:
            assert b not in live
            live.add(b)
        elif op == DROP:
            live.remove(a)
    return live


def _step_all(eng):
    while eng.step():
        assert _alive(eng.store.commands) == _held(eng)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_prefix_eviction_drops_what_pe0_lets_go(family):
    """Three distinct prompts and a repeat under a cap of one snapshot:
    every eviction (FIFO map on the SSM, tree nodes on the hybrid) and
    every republished prefix is a drop."""
    eng = _engine(family)
    rng = np.random.default_rng(4)
    vocab = CONFIGS[family].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (9, 10, 13)]
    for p in prompts + prompts[:1]:
        eng.submit(p, SamplingParams(max_tokens=3))
        _step_all(eng)
    kinds = {op for op, _, _ in eng.store.commands}
    assert {READ, DROP} <= kinds
    reads = sum(op == READ for op, _, _ in eng.store.commands)
    assert reads >= 3 and len(_held(eng)) == 1


def test_tree_eviction_drops_the_node_snapshot():
    """On the hybrid a pool too small for every prompt's pages evicts
    cached tree nodes, and their dense snapshots with them: drops the
    radix cache reports, under no snapshot cap."""
    eng = _engine("hybrid", cap=64, n_kv_blocks=8)
    rng = np.random.default_rng(7)
    vocab = CONFIGS["hybrid"].vocab_size
    for n in (13, 12, 13, 11, 13):
        eng.submit(rng.integers(0, vocab, size=n).tolist(),
                   SamplingParams(max_tokens=3))
        _step_all(eng)
    assert eng.stats.prefix_evictions > 0
    assert any(op == DROP for op, _, _ in eng.store.commands)


@pytest.mark.parametrize("end", ["restored", "cancelled"])
def test_preempted_snapshot_dropped_at_its_end(end):
    """A preempted page-free request's snapshot is dropped once it is
    written back at readmission, or when the request is cancelled while
    it waits."""
    eng = _engine("ssm")
    vocab = CONFIGS["ssm"].vocab_size
    rng = np.random.default_rng(3)
    r1 = eng.submit(rng.integers(0, vocab, size=5).tolist(),
                    SamplingParams(max_tokens=8))
    r2 = eng.submit(rng.integers(0, vocab, size=5).tolist(),
                    SamplingParams(max_tokens=8))
    for _ in range(4):
        eng.step()
    assert eng.scheduler._preempt_one(keep=r1) is r2
    sid = r2.dense_snapshot[1].sid
    assert sid in _alive(eng.store.commands)
    if end == "cancelled":
        assert eng.cancel(r2.request_id)
    _step_all(eng)
    assert (DROP, sid, 0) in eng.store.commands
    assert _alive(eng.store.commands) == _held(eng)
    assert r2.finish_reason == ("length" if end == "restored"
                                else "cancelled")


def test_a_follower_store_applies_the_log():
    """A second engine's store applying PE 0's log holds host copies under
    PE 0's numbers, exactly the live ones, each equal to its slot's rows
    when they were read (the two engines ran the same steps)."""
    lead, follower = _engine("ssm"), _engine("ssm")
    follower.store.commands = None
    rng = np.random.default_rng(5)
    vocab = CONFIGS["ssm"].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (9, 6, 9)]
    for eng in (lead, follower):
        for p in prompts:
            eng.submit(p, SamplingParams(max_tokens=3))
    done = 0
    while lead.step():
        follower.step()
        for op, a, b in lead.store.commands[done:]:
            if op == READ or op == DROP:
                follower.store.apply(op, a, b)
        done = len(lead.store.commands)
    assert set(follower.store._held) == _held(lead)
    for key, snap in lead.store._prefix.items():
        got = follower.store._held[snap.sid]
        assert set(got) == set(snap)
        for k in snap:
            assert torch.equal(got[k], snap[k]), (key, k)


def test_drain_serves_arrivals_at_their_steps():
    """``drain(arrivals)`` submits each request before the step it names,
    skips an idle engine ahead to the next arrival, and still holds
    ``max_steps``."""
    eng = build_engine(torch_config(CONFIGS["ssm"]), seed=0,
                       engine_cfg=EngineConfig(
                           s_max=S_MAX, buckets=(1, 2), block_pos_stride=4,
                           device="cpu"))
    reqs, at = [], []

    def submit(n):
        def go():
            at.append(eng.stats.steps)
            reqs.append(eng.submit([1 + n, 2, 3], SamplingParams(
                max_tokens=2)))
        return go
    eng.drain([(0, submit(0)), (2, submit(1)), (50, submit(2))])
    assert at[:2] == [0, 2] and at[2] < 50      # the idle gap skipped
    assert all(r.finish_reason == "length" for r in reqs)
    capped = build_engine(torch_config(CONFIGS["ssm"]), seed=0,
                          engine_cfg=EngineConfig(
                              s_max=S_MAX, buckets=(1, 2),
                              block_pos_stride=4, device="cpu",
                              max_steps=3))
    capped.submit([1, 2, 3], SamplingParams(max_tokens=10))
    with pytest.raises(RuntimeError, match="max_steps"):
        capped.drain()
