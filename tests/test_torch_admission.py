"""repro_torch's admission policies against the JAX package's.

Each scenario of tests/test_admission_policies.py runs twice on the same
inputs: once on the JAX package's scheduler, pool, requests and policies,
once on the port's copies, each scheduler driven directly with a fake
clock.  The requests each one admits, sheds and preempts (by submission
position), their states and queue waits, and the scheduler's counters
must be identical; each scenario also asserts what the JAX test asserts.
The deadline policy's measured prefill estimate (``bind``) is held the
same way against ``ServiceMetrics`` and a radix-cached pool.
"""

import types

import pytest

from repro.serve.engine import block_cache as j_block_cache
from repro.serve.engine import request as j_request
from repro.serve.engine import scheduler as j_scheduler
from repro.serve.service import admission as j_admission
from repro.serve.service import metrics as j_metrics
from repro_torch.serve.engine import block_cache as t_block_cache
from repro_torch.serve.engine import request as t_request
from repro_torch.serve.engine import scheduler as t_scheduler
from repro_torch.serve.service import admission as t_admission
from repro_torch.serve.service import metrics as t_metrics


def _ns(block_cache, request, scheduler, admission, metrics):
    return types.SimpleNamespace(
        BlockPool=block_cache.BlockPool, Request=request.Request,
        RequestState=request.RequestState,
        SamplingParams=request.SamplingParams,
        FifoAdmission=scheduler.FifoAdmission, Scheduler=scheduler.Scheduler,
        SchedulerConfig=scheduler.SchedulerConfig,
        DeadlineAdmission=admission.DeadlineAdmission,
        FairShareAdmission=admission.FairShareAdmission,
        make_policy=admission.make_policy, metrics=metrics)


JAX = _ns(j_block_cache, j_request, j_scheduler, j_admission, j_metrics)
PORT = _ns(t_block_cache, t_request, t_scheduler, t_admission, t_metrics)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class Run:
    """One scenario's world in one package: a scheduler over a pool, the
    requests it was given (in order) and a trace of what it decided."""

    def __init__(self, ns, policy=None, clock=None, n_blocks=64, stride=2,
                 buckets=(1, 2, 4)):
        self.ns = ns
        self.clock = clock or FakeClock()
        self.sched = ns.Scheduler(ns.BlockPool(n_blocks, stride),
                                  ns.SchedulerConfig(buckets),
                                  admission=policy, clock=self.clock)
        self.reqs = []
        self.trace = []

    def req(self, prompt_len=2, submit_t=100.0, **kw):
        r = self.ns.Request(list(range(1, prompt_len + 1)),
                            self.ns.SamplingParams(max_tokens=4), **kw)
        r.submit_t = submit_t
        self.reqs.append(r)
        return r

    def pos(self, rs):
        return [self.reqs.index(r) for r in rs]

    def schedule(self):
        """One schedule(), traced by request position."""
        sd = self.sched.schedule()
        s = self.sched
        row = {"none": sd is None,
               "waiting": self.pos(s.waiting), "running": self.pos(s.running),
               "states": [str(r.state) for r in self.reqs],
               "finish": [r.finish_reason for r in self.reqs],
               "queue_wait": [r.queue_wait_s for r in self.reqs],
               "n_shed": s.n_shed, "n_preemptions": s.n_preemptions,
               "n_free": s.pool.n_free}
        if sd is not None:
            row.update(admitted=self.pos(sd.admitted), shed=self.pos(sd.shed),
                       preempted=self.pos(sd.preempted),
                       slots=[None if r is None else self.reqs.index(r)
                              for r in sd.slots])
        self.trace.append(row)
        return sd


def _fifo_head_of_line(ns):
    w = Run(ns, n_blocks=4, buckets=(1, 2))
    w.sched.submit(w.req(prompt_len=2))
    w.schedule()                      # first running: holds 2 blocks
    big, small = w.req(prompt_len=5), w.req(prompt_len=1)
    w.sched.submit(big)
    w.sched.submit(small)
    sd = w.schedule()
    assert sd.admitted == [] and list(w.sched.waiting) == [big, small]
    return w


def _queue_wait_stamped_once(ns):
    clock = FakeClock(100.0)
    w = Run(ns, clock=clock, n_blocks=4, buckets=(1, 2))
    a, b = w.req(submit_t=90.0), w.req(submit_t=95.0)
    w.sched.submit(a)
    w.sched.submit(b)
    clock.t = 101.0
    w.schedule()
    assert (a.queue_wait_s, b.queue_wait_s) == pytest.approx((11.0, 6.0))
    w.sched._evict(b)
    clock.t = 107.0
    w.schedule()
    assert b.queue_wait_s == pytest.approx(6.0)
    return w


def _deadline_edf_skips_blocked(ns):
    w = Run(ns, policy=ns.DeadlineAdmission(), n_blocks=4, buckets=(1, 2))
    w.sched.submit(w.req(prompt_len=2))
    w.schedule()
    big = w.req(prompt_len=5, ttft_deadline_s=0.4)
    lax = w.req(prompt_len=1, ttft_deadline_s=0.9)
    w.sched.submit(big)
    w.sched.submit(lax)
    sd = w.schedule()
    assert sd.admitted == [lax] and big in w.sched.waiting
    return w


def _deadline_sheds_infeasible(ns):
    clock = FakeClock(100.0)
    w = Run(ns, policy=ns.DeadlineAdmission(est_ttft_s=0.1), clock=clock)
    doomed = w.req(ttft_deadline_s=0.5)
    fine, noslo = w.req(ttft_deadline_s=5.0), w.req()
    for r in (doomed, fine, noslo):
        w.sched.submit(r)
    clock.t = 100.45
    sd = w.schedule()
    assert sd.shed == [doomed] and doomed.finish_reason == "shed"
    assert doomed.queue_wait_s is None and w.sched.n_shed == 1
    return w


def _fair_share_round_robin(ns):
    w = Run(ns, policy=ns.FairShareAdmission(), buckets=(1, 2, 4))
    a1, a2, a3 = (w.req(tenant="a") for _ in range(3))
    b1 = w.req(tenant="b")
    for r in (a1, a2, a3, b1):
        w.sched.submit(r)
    w.sched.config = ns.SchedulerConfig((1, 2))
    sd = w.schedule()
    assert set(sd.admitted) == {a1, b1}
    assert list(w.sched.waiting) == [a2, a3]
    return w


def _fair_share_priority_preempts(ns):
    w = Run(ns, policy=ns.FairShareAdmission(), buckets=(1, 2))
    lo1, lo2 = w.req(priority=0), w.req(priority=0)
    w.sched.submit(lo1)
    w.sched.submit(lo2)
    w.schedule()
    hi = w.req(priority=5)
    w.sched.submit(hi)
    sd = w.schedule()
    assert hi in sd.admitted and sd.preempted == [lo2]
    assert lo2.n_preemptions == 1 and w.sched.n_preemptions == 1
    return w


def _fair_share_never_preempts_equal(ns):
    w = Run(ns, policy=ns.FairShareAdmission(), buckets=(1, 2))
    a, b = w.req(priority=1), w.req(priority=1)
    w.sched.submit(a)
    w.sched.submit(b)
    w.schedule()
    c = w.req(priority=1)
    w.sched.submit(c)
    sd = w.schedule()
    assert sd.admitted == [] and sd.preempted == [] and c in w.sched.waiting
    return w


def _shed_frees_nothing(ns):
    clock = FakeClock(100.0)
    w = Run(ns, policy=ns.DeadlineAdmission(), clock=clock)
    r = w.req(ttft_deadline_s=0.1)
    w.sched.submit(r)
    clock.t = 101.0
    assert w.schedule() is None
    assert r.finish_reason == "shed" and not w.sched.has_work
    assert w.sched.pool.n_free == w.sched.pool.n_blocks
    return w


def _deadline_bound_to_measured_prefill(ns):
    """The bound policy prices a request by the metrics' prefill EMA times
    its prompt tokens past the radix-matched prefix."""
    clock = FakeClock(100.0)
    pool = ns.BlockPool(64, 2, prefix_cache=True)
    metrics = ns.metrics.ServiceMetrics()
    for wait, ttft, n in ((0.0, 0.2, 10), (0.05, 0.3, 10), (0.0, 0.1, 4)):
        metrics.observe(ns.metrics.RequestMetrics(
            request_id="r", tenant="t", priority=0, finish_reason="length",
            n_tokens=2, ttft_s=ttft, queue_wait_s=wait, itl_s=[0.01],
            n_prompt_tokens=n))
    policy = ns.DeadlineAdmission(est_ttft_s=0.01)
    policy.bind(types.SimpleNamespace(
        pool=pool, store=types.SimpleNamespace(needs_pages=True)), metrics)
    w = Run(ns, policy=policy, clock=clock)
    w.sched.pool = pool
    shared = list(range(1, 9))
    pool.publish_prefix(tuple(shared[:2]), pool.alloc())
    pool.publish_prefix(tuple(shared[:4]), pool.alloc())
    cached = w.req(prompt_len=8, ttft_deadline_s=0.09)
    cold = ns.Request(list(range(50, 58)), ns.SamplingParams(max_tokens=4),
                      ttft_deadline_s=0.09)
    cold.submit_t = 100.0
    w.reqs.append(cold)
    w.sched.submit(cached)
    w.sched.submit(cold)
    w.trace.append({"est": [policy._est(r) for r in (cached, cold)],
                    "prefill": metrics.prefill_estimate()})
    w.schedule()
    assert cold.finish_reason == "shed" and cached.finish_reason is None
    return w


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _fifo_head_of_line, _queue_wait_stamped_once, _deadline_edf_skips_blocked,
    _deadline_sheds_infeasible, _fair_share_round_robin,
    _fair_share_priority_preempts, _fair_share_never_preempts_equal,
    _shed_frees_nothing, _deadline_bound_to_measured_prefill)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_match_jax(name):
    got = SCENARIOS[name](PORT).trace
    want = SCENARIOS[name](JAX).trace
    assert got == want


def test_make_policy_registry_and_request_slo_metadata_match_jax():
    for ns in (PORT, JAX):
        assert isinstance(ns.make_policy("fifo"), ns.FifoAdmission)
        assert isinstance(ns.make_policy("deadline"), ns.DeadlineAdmission)
        assert isinstance(ns.make_policy("fair_share"),
                          ns.FairShareAdmission)
        assert ns.make_policy("deadline", est_ttft_s=0.25).est_ttft_s == 0.25
        with pytest.raises(ValueError, match="unknown admission policy"):
            ns.make_policy("edf")
        with pytest.raises(ValueError, match="est_ttft_s"):
            ns.DeadlineAdmission(est_ttft_s=-1.0)
        r = ns.Request([1], ns.SamplingParams(max_tokens=4), priority=3,
                       tenant="t0", ttft_deadline_s=0.5)
        r.submit_t = 100.0
        f = r.fork()
        assert (r.deadline_t, f.priority, f.tenant, f.ttft_deadline_s) == \
            (100.5, 3, "t0", 0.5)
        with pytest.raises(ValueError, match="ttft_deadline_s"):
            ns.Request([1], ttft_deadline_s=0.0)
