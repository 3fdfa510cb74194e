"""The work of one grouped-GEMM launch, from its shapes and offsets.

One copy of the count that the bounds and the dry run read: the
operations ``2 * rows * K * N`` of every product (forward, the fused
swiglu, dgrad, wgrad), and the elements it must move, each input read
once and each output written once:

  * ``forward`` — the active experts' weights ``active * K * N``, the
    routed rows of x and of the output, ``rows * (K + N)``;
  * ``swiglu`` — the same with the output's N / 2 columns (the epilogue
    writes silu(gate) x up, never the (rows, N) product);
  * ``dgrad`` — dy's routed rows, the active experts' weights and dx:
    ``active * K * N + rows * (K + N)``;
  * ``wgrad`` — x's and dy's routed rows and every expert's dw, zeros
    included: ``rows * (K + N) + E * K * N``.

``rows`` is ``offsets[E] - offsets[0]`` and ``active`` the experts with at
least one row (:func:`from_offsets` reads them from host offsets).  On
the meta device there are no offsets to read: the meta route of
:mod:`.ops` counts every row of x, which is what ``models/moe.py::
_n_kept`` keeps at a ``capacity_factor`` of 1 or more (every config of the
registry), and ``min(E, rows)`` active experts.

:func:`counting` opens a :class:`GmmCount`; while it is open, every
launch the meta route stands in for adds its operations and bytes to it
(:func:`record`).  A launch on the card or on the CPU adds nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np

KINDS = ("forward", "swiglu", "dgrad", "wgrad")


def operations(rows: int, K: int, N: int) -> int:
    """Multiply-adds of one product, counted as two operations each."""
    return 2 * rows * K * N


def elements(kind: str, rows: int, K: int, N: int, E: int,
             active: int) -> int:
    """Elements one launch of ``kind`` must move (module docstring)."""
    if kind == "forward":
        return active * K * N + rows * (K + N)
    if kind == "swiglu":
        return active * K * N + rows * (K + N // 2)
    if kind == "dgrad":
        return active * K * N + rows * (K + N)
    if kind == "wgrad":
        return rows * (K + N) + E * K * N
    raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def from_offsets(offsets) -> Tuple[int, int, int]:
    """(rows, active experts, E) of host offsets (E + 1,)."""
    off = np.asarray(offsets).astype(np.int64)
    return int(off[-1] - off[0]), int((np.diff(off) > 0).sum()), \
        len(off) - 1


@dataclasses.dataclass
class GmmCount:
    """Launches, operations and bytes of the grouped GEMM, per kind."""
    launches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    flops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


_OPEN: List[GmmCount] = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def counting() -> Iterator[GmmCount]:
    """Open a count for the launches recorded until the block ends (the
    autograd engine may run a backward on another thread: the open
    counts are the process's, not the thread's)."""
    c = GmmCount()
    with _LOCK:
        _OPEN.append(c)
    try:
        yield c
    finally:
        with _LOCK:
            _OPEN.remove(c)


def record(kind: str, rows: int, K: int, N: int, E: int, active: int,
           esz: int) -> None:
    """Add one launch of ``kind`` to every open count."""
    flops = operations(rows, K, N)
    nbytes = elements(kind, rows, K, N, E, active) * esz
    with _LOCK:
        for c in _OPEN:
            c.launches[kind] += 1
            c.flops[kind] += flops
            c.bytes[kind] += nbytes
