"""Synchronous facade: ``generate(prompts, sampling) -> completions``.

The smallest useful surface over :class:`ServingEngine` — submit a batch of
prompts, drain the engine, and return per-request completions carrying
per-request TTFT.  For incremental consumption use the generator facade
``engine.stream(prompt)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.serve.engine.engine import EngineConfig, ServingEngine
from repro_torch.serve.engine.request import SamplingParams


@dataclasses.dataclass(frozen=True)
class Completion:
    request_id: str
    prompt: List[int]
    tokens: List[int]              # generated tokens (incl. EOS when hit)
    # one of request.FINISH_REASONS
    finish_reason: str
    n_preemptions: int
    ttft_s: Optional[float] = None  # submit-to-first-token (None if no token)
    # submit-to-first-admission wait (None when never admitted)
    queue_wait_s: Optional[float] = None
    # steady-state decode rate excluding TTFT: (tokens - 1) over the
    # first-token-to-finish span; None with < 2 tokens
    decode_tok_s: Optional[float] = None


def completion_of(request) -> Completion:
    """Freeze one finished (or mid-flight) Request into a Completion."""
    return Completion(request_id=request.request_id,
                      prompt=list(request.prompt),
                      tokens=list(request.output_tokens),
                      finish_reason=request.finish_reason or "length",
                      n_preemptions=request.n_preemptions,
                      ttft_s=request.ttft_s,
                      queue_wait_s=request.queue_wait_s,
                      decode_tok_s=request.decode_tok_s)


def build_engine(cfg, *, engine_cfg: Optional[EngineConfig] = None,
                 params=None, seed: int = 0) -> ServingEngine:
    """Construct an engine (initializing fresh params when none are given)."""
    return ServingEngine(cfg, params=params, engine_cfg=engine_cfg, seed=seed)


def generate(engine: ServingEngine, prompts: Sequence[Sequence[int]],
             sampling: Union[SamplingParams, Sequence[SamplingParams],
                             None] = None) -> List[Completion]:
    """Submit ``prompts``, run the engine to completion, return completions.

    ``sampling`` may be one ``SamplingParams`` for all prompts or a
    per-prompt sequence.  Drains *all* outstanding work on the engine.
    """
    if sampling is None or isinstance(sampling, SamplingParams):
        per = [sampling or SamplingParams()] * len(prompts)
    else:
        per = list(sampling)
        if len(per) != len(prompts):
            raise ValueError(
                f"{len(prompts)} prompts but {len(per)} sampling params")
    requests = [engine.submit(p, s) for p, s in zip(prompts, per)]
    engine.drain()
    return [completion_of(r) for r in requests]
