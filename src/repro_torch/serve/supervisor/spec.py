"""Picklable engine recipe: rebuild the SAME ServingEngine in a fresh process
(``repro.serve.supervisor.spec`` on one device).

Card tensors cannot cross a process boundary, and shipping the weights
through a pipe would dwarf every other supervisor cost.  So the replica
worker receives neither: it receives this recipe and rebuilds the engine,
its weights drawn by the seed-keyed initializer on the device that
``engine_cfg.device`` names.  One card is a 1x1 grid, so there is no mesh
to rebuild.  Two processes building from the same spec on the same card
hold bit-identical engines, the property the supervisor's failover parity
stands on.

``params_path`` carries weights instead of a seed: a ``torch.save`` file
of CPU tensors (the port's parameter tree) that the worker loads onto its
device.  The port's initializer draws other numbers than the JAX
package's, so this is how a supervised port run serves the JAX package's
weights (``repro_torch.models.params.from_jax_params``).

Everything here must survive ``pickle`` under the ``multiprocessing``
*spawn* start method (a forked child cannot use the parent's CUDA
context): ``ModelConfig`` and ``EngineConfig`` are plain dataclasses, and
a ``FaultInjector`` inside the engine config pickles with its seed and rng
state, so every worker incarnation starts an identical fault schedule.
The spec refuses, when it is made, an engine config that holds a tensor
or a drafter object (a ``DraftModelDrafter`` owns a queue and card
tensors); a ``SpeculationConfig`` names its drafter by kind, and the
worker's engine builds it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.serve.engine.engine import EngineConfig, ServingEngine


def _live_objects(node, path: str):
    """(path, object) of every tensor or drafter object reachable through
    the dataclass fields, dicts, lists and tuples of ``node``."""
    if isinstance(node, torch.Tensor):
        yield path, node
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _live_objects(getattr(node, f.name),
                                     f"{path}.{f.name}")
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _live_objects(v, f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _live_objects(v, f"{path}[{i}]")
    elif hasattr(node, "propose") and hasattr(node, "release"):
        yield path, node                # a drafter object


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Everything a fresh process needs to rebuild one serving replica."""

    model_cfg: object                 # repro_torch.models.config.ModelConfig
    engine_cfg: EngineConfig
    seed: int = 0                     # params are a pure function of this
    params_path: Optional[str] = None  # or: torch.save'd CPU params

    def __post_init__(self):
        for path, obj in _live_objects(self.engine_cfg, "engine_cfg"):
            raise TypeError(
                f"EngineSpec: {path} holds a {type(obj).__name__}, which "
                f"cannot cross into a spawned worker; name the drafter by "
                f"kind in SpeculationConfig (the worker's engine builds it) "
                f"and pass weights through params_path")

    def build(self) -> ServingEngine:
        """Construct the engine: params loaded from ``params_path`` onto
        the engine's device, else initialized there from ``seed``, so
        every incarnation built from this spec is parameter-identical."""
        params = None
        if self.params_path is not None:
            params = torch.load(self.params_path,
                                map_location=resolve_device(
                                    self.engine_cfg.device))
        return ServingEngine(self.model_cfg, params=params,
                             engine_cfg=self.engine_cfg, seed=self.seed)
