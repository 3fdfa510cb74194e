"""The parallelism plan of a grid of PE processes.

``repro.partition`` without JAX: the JAX package numbers its PEs flat along
the ``model`` axis of a device mesh and treats that axis as a logical
``q x r`` grid (row-major, ``pe = i * r + j``; ``i`` the grid row, which
shards vocabulary rows, K blocks of a weight and the pages of the paged KV
arena, ``j`` the grid column, which shards features and heads).  Here a PE
is a process (:mod:`repro_torch.runtime.pe`), so the plan holds no
``PartitionSpec``: only the axis names and sizes, the grid and the PE
arithmetic.  The data axis is 1, since the paged serving engine has one
page id space and refuses more (``repro/serve/engine/engine.py:186-191``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DATA = "data"
MODEL = "model"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A ``grid_q x grid_r`` PE grid on the ``model`` axis (``data`` 1)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    grid_q: int                          # grid rows
    grid_r: int                          # grid cols

    def __post_init__(self):
        if tuple(self.axis_names) != (DATA, MODEL):
            raise ValueError(f"axes must be ({DATA!r}, {MODEL!r}), got "
                             f"{self.axis_names}")
        if self.grid_q < 1 or self.grid_r < 1:
            raise ValueError(f"grid {self.grid_q}x{self.grid_r} must be at "
                             f"least 1x1")
        if self.data_size != 1:
            raise NotImplementedError(
                f"the paged engine requires data_size == 1, got "
                f"{self.data_size} shards (each data shard would need its "
                f"own page id space)")
        if self.grid_q * self.grid_r != self.model_size:
            raise ValueError(f"grid {self.grid_q}x{self.grid_r} != model "
                             f"axis {self.model_size}")

    @property
    def data_size(self) -> int:
        return self.axis_sizes[self.axis_names.index(DATA)]

    @property
    def model_size(self) -> int:
        return self.axis_sizes[self.axis_names.index(MODEL)]

    @property
    def n_pes(self) -> int:
        return self.grid_q * self.grid_r

    def coords(self, pe: int) -> Tuple[int, int]:
        """PE ``pe`` -> its grid ``(row, col)``."""
        if not 0 <= pe < self.n_pes:
            raise ValueError(f"PE {pe} outside a {self.n_pes}-PE grid")
        return divmod(pe, self.grid_r)


def grid_plan(q: int, r: Optional[int] = None) -> MeshPlan:
    """The plan of a ``q x r`` grid (``r`` defaults to ``q``)."""
    r = q if r is None else r
    return MeshPlan((DATA, MODEL), (1, q * r), q, r)


def parse_grid(text: str) -> MeshPlan:
    """``"QxR"`` (e.g. ``"2x2"``) -> ``grid_plan(Q, R)``."""
    q, r = (int(v) for v in text.lower().split("x"))
    return grid_plan(q, r)


def divide(a: int, b: int, what: str = "") -> int:
    if a % b:
        raise ValueError(f"{what}: {a} not divisible by {b}")
    return a // b


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
