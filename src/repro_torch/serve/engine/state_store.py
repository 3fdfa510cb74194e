"""Device-resident engine state, driven by the per-layer StateSpec list.

The store owns the ONE bucket-independent state arena the step bodies
consume — one allocation per leaf, on the engine's device, for the engine's
whole lifetime — and is the scheduler's state hook (``needs_pages`` /
``plan_resume`` / ``can_admit`` / ``commit_admit`` / ``on_release``).  This
is the paged half of ``repro.serve.engine.state_store``: attention layers
page their K/V, pages are the scheduler/pool's job, and every dense-state
lifecycle event is a no-op.  Dense (SSM) slots come with the SSM/hybrid
slice.
"""

from __future__ import annotations

import torch

from repro_torch.serve.state import ModelStateSpecs


class NullStateHook:
    """Hook face with no dense-state layers: pages are the whole story, so
    every dense lifecycle event is a no-op and admission resumes exactly as
    far as adoptable pages reach."""

    needs_pages = True
    has_dense = False

    def plan_resume(self, request, page_cap: int) -> int:
        return page_cap

    def can_admit(self, request) -> bool:
        return True

    def commit_admit(self, request, resume: int) -> None:
        pass

    def on_release(self, request, preempting: bool = False) -> None:
        pass


class StateStore(NullStateHook):
    """One engine's resident device state + its lifecycle hook face."""

    def __init__(self, specs: ModelStateSpecs, *, n_blocks: int,
                 device: torch.device):
        self.specs = specs
        # ONE arena for the engine's lifetime; the step bodies write new
        # K/V into it in place.  Pages are never zeroed again: stale KV past
        # a slot's position is causally masked in the kernel.
        self.arena = [{name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in entry.items()}
                      for entry in specs.arena_shapes(n_blocks)]

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for entry in self.arena for t in entry.values())
