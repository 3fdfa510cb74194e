"""Per-layer StateSpec ABI: the engine <-> step-body state contract.

The single source of truth for the device shapes of the engine's resident
state arena, the step operands derived from it, and its bytes-resident
accounting — ``repro.serve.state`` at q = r = 1.  This slice serves
attention mixers, whose K/V grow with sequence length and so are split
into physical pages addressed through per-slot block tables
(:class:`PagedSpec`).  Recurrent (SSM) mixers, whose O(1) state lives in
dense slots, come with the SSM/hybrid slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Attention-mixer state: K/V pages addressed through a block table.

    The arena leaf for one layer position is
    ``(G, n_blocks, stride, kvh, hd)``: one grid row owns every page."""

    kvh: int                      # stored kv heads
    hd: int                       # head dim
    stride: int                   # cache positions per physical page
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError("stride must be >= 1")

    @property
    def leaves(self) -> Mapping[str, Tuple[Tuple[int, ...], Any]]:
        """name -> (per-page shape, dtype)."""
        shape = (self.stride, self.kvh, self.hd)
        return {"k": (shape, self.dtype), "v": (shape, self.dtype)}


@dataclasses.dataclass(frozen=True)
class ModelStateSpecs:
    """The per-layer state contract of one model on one device."""

    entries: Tuple[PagedSpec, ...]     # one per pattern position
    groups: int                        # layer groups (leading arena dim)

    @property
    def has_paged(self) -> bool:
        return any(isinstance(e, PagedSpec) for e in self.entries)

    @property
    def stride(self) -> int:
        return self.entries[0].stride

    def arena_shapes(self, n_blocks: int) -> List[Dict[str, Tuple]]:
        """name -> (shape, dtype) of every arena leaf, per pattern position."""
        return [{name: ((self.groups, n_blocks) + shape, dt)
                 for name, (shape, dt) in e.leaves.items()}
                for e in self.entries]

    def page_bytes(self) -> int:
        """Device bytes of ONE physical page across all paged layers."""
        total = 0
        for e in self.entries:
            for shape, dt in e.leaves.values():
                n = 1
                for d in shape:
                    n *= d
                total += self.groups * n * torch.empty((), dtype=dt) \
                    .element_size()
        return total


def layer_state_specs(cfg: ModelConfig, *, stride: int,
                      kvh: Optional[int] = None) -> ModelStateSpecs:
    """Derive the per-layer state contract from ``ModelConfig.pattern()``.

    ``kvh`` is the stored kv-head count of the weights being served (see
    :func:`repro_torch.models.params.stored_heads`); it defaults to the
    config's native count."""
    kvh = kvh if kvh is not None else cfg.kv_stored(1)[0]
    entries: List[PagedSpec] = []
    for (mixer, _) in cfg.pattern():
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: mixer {mixer!r} carries dense state — "
                f"SSM/hybrid: later slice")
        entries.append(PagedSpec(kvh=kvh, hd=cfg.hd(), stride=stride,
                                 dtype=cfg.compute_dtype))
    return ModelStateSpecs(entries=tuple(entries), groups=cfg.n_groups())
