"""Request/sequence lifecycle for the continuous-batching engine.

State machine (SHARK's ``GenerateRequest`` distilled to the hybrid model):

    WAITING --admit--> PREFILL --last prompt token--> DECODE --stop--> FINISHED
       ^                  |                              |
       +----preempt-------+------------preempt----------+

A preempted request drops its KV blocks and re-enters WAITING with
``num_cached = 0``; on re-admission it replays prompt *and* already-generated
tokens through the step kernel (recompute-style preemption — no KV swap).
Cancellation is legal from any non-terminal state and is recorded as
``finish_reason == "cancelled"``; an admission policy rejecting a WAITING
request (TTFT deadline infeasible) finishes it as ``"shed"``; the
resilience layer quarantines a repeatedly-failing request as ``"error"``
and a graceful service drain checkpoints live requests and finishes them
as ``"drained"`` — the full ``finish_reason`` vocabulary is
:data:`FINISH_REASONS` = {stop, length, cancelled, shed, error, drained}.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional, Sequence


class RequestState:
    WAITING = "WAITING"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    FINISHED = "FINISHED"


_TRANSITIONS = {
    RequestState.WAITING: {RequestState.PREFILL, RequestState.FINISHED},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.WAITING,
                           RequestState.FINISHED},
    RequestState.DECODE: {RequestState.WAITING, RequestState.FINISHED},
    RequestState.FINISHED: set(),
}

# The CLOSED vocabulary of terminal outcomes.  "stop"/"length" are natural
# completions; the rest name which layer terminated the request early:
# "cancelled" (client), "shed" (admission policy), "error" (resilience
# quarantine: repeated step failures or non-finite logits), "drained"
# (graceful service drain — the request was checkpointed, not lost).
FINISH_REASONS = frozenset(
    {"stop", "length", "cancelled", "shed", "error", "drained"})


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (greedy when ``temperature == 0``)."""

    max_tokens: int = 16
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")


_request_ids = itertools.count()


class Request:
    """One in-flight generation request (sequence + scheduling state)."""

    def __init__(self, prompt: Sequence[int],
                 sampling: Optional[SamplingParams] = None,
                 request_id: Optional[str] = None, *,
                 priority: int = 0, tenant: str = "default",
                 ttft_deadline_s: Optional[float] = None):
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if ttft_deadline_s is not None and ttft_deadline_s <= 0:
            raise ValueError(
                f"ttft_deadline_s must be > 0, got {ttft_deadline_s}")
        self.request_id = request_id or f"req-{next(_request_ids)}"
        self.prompt = prompt
        self.sampling = sampling or SamplingParams()
        # SLO metadata, consumed by the admission-policy layer
        # (the service slice): higher priority admits first
        # under fair_share and may preempt lower-priority running work;
        # ttft_deadline_s is the submit-relative first-token deadline the
        # deadline policy schedules (and sheds) against.
        self.priority = int(priority)
        self.tenant = tenant
        self.ttft_deadline_s = \
            None if ttft_deadline_s is None else float(ttft_deadline_s)
        self.state = RequestState.WAITING
        self.output_tokens: List[int] = []
        # KV entries written to the device cache so far.  In steady-state
        # decode this equals len(seq_tokens) - 1: the step feeds
        # seq_tokens[num_cached] and yields the logits that extend the
        # sequence.
        self.num_cached = 0
        self.slot: Optional[int] = None      # batch slot while scheduled
        self.blocks = None                   # SequenceBlocks while scheduled
        # dense-state (DenseSpec) bookkeeping: the arena slot holding this
        # sequence's O(1) recurrent state while scheduled, and — for
        # replay-free preemption restore on page-free (ssm-family) configs —
        # a host snapshot ``(position, leaves)`` of that state at eviction
        self.dense_slot: Optional[int] = None
        self.dense_snapshot = None
        self.finish_reason: Optional[str] = None
        self.n_preemptions = 0
        # consecutive failed/poisoned steps (StepGuard bookkeeping); reset
        # to 0 by every committed step, quarantined past the threshold
        self.fault_failures = 0
        # perf_counter stamps for time-to-first-token (0.0 = not yet);
        # admit_t is the FIRST admission (queue-wait ends there — a later
        # preemption/re-admission is a scheduling event, not queue wait)
        self.submit_t = 0.0
        self.first_token_t = 0.0
        self.admit_t = 0.0
        self.finish_t = 0.0

    # -- sequence view -----------------------------------------------------

    @property
    def seq_tokens(self) -> List[int]:
        return self.prompt + self.output_tokens

    @property
    def next_token(self) -> int:
        """Token this request feeds at its next step (position num_cached)."""
        return self.seq_tokens[self.num_cached]

    @property
    def samples_this_step(self) -> bool:
        """True when the next step's logits extend the sequence."""
        return self.num_cached == len(self.seq_tokens) - 1

    @property
    def remaining_known(self) -> int:
        """Known-but-unfed tokens: the prompt (plus replayed outputs) still
        to ingest while prefilling, exactly 1 in steady-state decode.  The
        engine sizes chunked-prefill launches from the per-slot values the
        scheduler exposes (``ScheduledStep.remaining``)."""
        return len(self.seq_tokens) - self.num_cached

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-sampled-token latency (None until sampled)."""
        if self.submit_t and self.first_token_t:
            return self.first_token_t - self.submit_t
        return None

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit-to-first-admission latency (None until admitted)."""
        if self.submit_t and self.admit_t:
            return self.admit_t - self.submit_t
        return None

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute first-token deadline on the perf_counter clock (None
        when no TTFT SLO was requested or the request is not yet
        submitted)."""
        if self.ttft_deadline_s is not None and self.submit_t:
            return self.submit_t + self.ttft_deadline_s
        return None

    @property
    def is_finished(self) -> bool:
        return self.state == RequestState.FINISHED

    def fork(self, sampling: Optional[SamplingParams] = None) -> "Request":
        """A fresh WAITING request over the same prompt (n>1 sampling from
        one prompt).  The fork dedupes *device* memory, not just
        accounting: at admission the scheduler adopts the parent's
        published full prompt pages through the pool's prefix map, so both
        sequences' block tables point at the same physical arena pages."""
        return Request(self.prompt, sampling or self.sampling,
                       priority=self.priority, tenant=self.tenant,
                       ttft_deadline_s=self.ttft_deadline_s)

    # -- state machine -----------------------------------------------------

    def transition(self, new_state: str) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise ValueError(
                f"{self.request_id}: illegal transition "
                f"{self.state} -> {new_state}")
        self.state = new_state

    @property
    def decode_tok_s(self) -> Optional[float]:
        """Steady-state decode rate: tokens after the first, over the
        first-token-to-finish span (None until finished with >= 2 tokens).
        TTFT is excluded on purpose — this is the per-request metric
        speculative decoding improves."""
        if self.first_token_t and self.finish_t > self.first_token_t \
                and len(self.output_tokens) >= 2:
            return (len(self.output_tokens) - 1) \
                / (self.finish_t - self.first_token_t)
        return None

    def finish(self, reason: str) -> None:
        if reason not in FINISH_REASONS:
            raise ValueError(f"unknown finish_reason {reason!r}; "
                             f"vocabulary: {sorted(FINISH_REASONS)}")
        self.transition(RequestState.FINISHED)
        self.finish_reason = reason
        self.finish_t = time.perf_counter()

    def preempt(self) -> None:
        """Back to WAITING, dropping cache progress (blocks freed by caller)."""
        self.transition(RequestState.WAITING)
        self.num_cached = 0
        self.slot = None
        self.n_preemptions += 1

    def finish_reason_for(self, token: int, s_max: int) -> Optional[str]:
        """Termination rule applied after ``token`` was appended."""
        sp = self.sampling
        if sp.eos_token_id is not None and token == sp.eos_token_id:
            return "stop"
        if len(self.output_tokens) >= sp.max_tokens:
            return "length"
        if self.num_cached >= s_max:      # cache full: cannot take more steps
            return "length"
        return None

    def __repr__(self):
        return (f"Request({self.request_id}, {self.state}, "
                f"prompt={len(self.prompt)}, out={len(self.output_tokens)}, "
                f"cached={self.num_cached}, slot={self.slot})")
