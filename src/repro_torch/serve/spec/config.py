"""Speculation configuration: pure data, importable from anywhere.

A copy of ``repro.serve.spec.config``.  ``SpeculationConfig`` rides on
:class:`repro_torch.serve.engine.EngineConfig` (``speculation=``) and is
deliberately free of engine imports so the engine, the drafters and the
benches can all consume it without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DRAFTER_KINDS = ("ngram", "draft_model")


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Engine-level speculative-decoding controls.

    ``k`` is the MAXIMUM draft length per slot per verify launch (the
    ``verify_bs{N}_len{k+1}`` step graphs are sized by it); the
    per-request acceptance-rate EMA adapts the effective k downward, and
    a request whose EMA rounds to zero falls back to plain decode with a
    probe draft every ``probe_every`` rounds so it can recover when its
    output becomes predictable again.
    """

    drafter: str = "ngram"          # "ngram" | "draft_model"
    k: int = 4                      # max draft tokens per slot per launch
    # n-gram/prompt-lookup drafter: match the last n in [ngram_min,
    # ngram_max] tokens of the sequence against its own history
    ngram_max: int = 3
    ngram_min: int = 1
    # acceptance-rate EMA (per request): k_eff = round(ema * k)
    ema_alpha: float = 0.5
    probe_every: int = 8            # rounds between probes once ema ~ 0
    # draft_model drafter: registry config name (reduced) for the second
    # CommandQueue's model; None keeps the engine config's default choice
    draft_config: Optional[str] = None
    draft_seed: int = 0             # param init seed for the draft model

    def __post_init__(self):
        if self.drafter not in DRAFTER_KINDS:
            raise ValueError(
                f"drafter must be one of {DRAFTER_KINDS}: {self.drafter!r}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"({self.ngram_min}, {self.ngram_max})")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(
                f"ema_alpha must be in (0, 1], got {self.ema_alpha}")
        if self.probe_every < 1:
            raise ValueError(
                f"probe_every must be >= 1, got {self.probe_every}")
