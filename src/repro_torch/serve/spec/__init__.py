"""Speculative decoding on the chunked-prefill ABI
(``repro.serve.spec`` on one device).

Draft (``drafter``), verify-in-one-launch (``decoder`` +
``prefill_chunk_step(all_logits=True)``, the engine's
``verify_bs{N}_len{k+1}`` step), accept/reject (``accept``), roll back
rejected pages/state (``SequenceBlocks.rewind`` +
``StateStore.restore_slot``).  Enable per engine via
``EngineConfig(speculation=SpeculationConfig(...))``.
"""

from repro_torch.serve.spec.accept import accept_draft, softmax_rows
from repro_torch.serve.spec.config import DRAFTER_KINDS, SpeculationConfig
from repro_torch.serve.spec.decoder import SpecDecoder
from repro_torch.serve.spec.drafter import (DraftModelDrafter, Drafter,
                                            NgramDrafter, make_drafter)

__all__ = [
    "DRAFTER_KINDS",
    "DraftModelDrafter",
    "Drafter",
    "NgramDrafter",
    "SpecDecoder",
    "SpeculationConfig",
    "accept_draft",
    "make_drafter",
    "softmax_rows",
]
