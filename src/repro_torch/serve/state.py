"""Per-layer StateSpec ABI: the engine <-> step-body state contract.

The single source of truth for the device shapes of the engine's resident
state arena, the step operands derived from it, and its bytes-resident
accounting — ``repro.serve.state``: on one device, or, given a grid plan,
on one PE of a grid of PE processes, where a PE holds its grid column's
share of the kv heads (``kv_stored(r) // r``) and physical page ``p`` lives
on grid row ``p % q`` at local index ``p // q``, so a PE's paged leaves
hold ``ceil(n_blocks / q)`` pages.  Two state kinds cover every mixer the
port serves:

  :class:`PagedSpec`  — attention: K/V grow with sequence length, so they
      are split into physical pages addressed through per-slot block
      tables (a ``table`` step operand).
  :class:`DenseSpec`  — SSM (Mamba2/SSD): state is O(1) per sequence, so
      it lives in fixed per-sequence *slots* addressed through a per-lane
      ``slots`` step operand.  Dense state is not ref-countable the way
      pages are: sharing it means physically copying a snapshot
      (``engine/state_store.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Attention-mixer state: K/V pages addressed through a block table.

    The arena leaf for one layer position is
    ``(G, n_blocks_local, stride, kvh, hd)``: on one device every page, on
    a grid the pages of this PE's row."""

    kvh: int                      # stored kv heads (this PE's share)
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
class DenseSpec:
    """Recurrent-mixer state: O(1) per sequence, held in dense slots.

    ``leaves`` holds (name, per-slot shape, dtype); for Mamba2 that is
    ``conv`` (the (k-1)-step pre-activation window) and ``ssm`` (the
    (H, N, P) SSD state, fp32).  The arena leaf for one layer position is
    ``(G, n_slots) + shape``."""

    leaves: Tuple[Tuple[str, Tuple[int, ...], Any], ...]


StateSpec = Union[PagedSpec, DenseSpec]


def _mamba_dense_spec(cfg: ModelConfig, r: int = 1) -> DenseSpec:
    """A mamba layer's slot on one PE: its columns' ``(d_inner + 2 G N) /
    r`` conv channels and ``H / r`` heads (``repro/serve/state.py:95``)."""
    conv_ch = (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) // r
    return DenseSpec(leaves=(
        ("conv", (cfg.conv_kernel - 1, conv_ch), cfg.compute_dtype),
        ("ssm", (cfg.ssm_heads // r, cfg.ssm_state, cfg.ssm_headdim),
         torch.float32),
    ))


@dataclasses.dataclass(frozen=True)
class ModelStateSpecs:
    """The per-layer state contract of one model on one device."""

    entries: Tuple[StateSpec, ...]     # one per pattern position
    groups: int                        # layer groups (leading arena dim)
    q: int = 1                         # grid rows (page id space shards)
    r: int = 1                         # grid cols (head shards)

    @property
    def has_paged(self) -> bool:
        return any(isinstance(e, PagedSpec) for e in self.entries)

    @property
    def has_dense(self) -> bool:
        return any(isinstance(e, DenseSpec) for e in self.entries)

    @property
    def stride(self) -> int:
        for e in self.entries:
            if isinstance(e, PagedSpec):
                return e.stride
        raise ValueError("no paged layer: stride is undefined")

    def blocks_local(self, n_blocks: int) -> int:
        """Pages a PE holds of a pool of ``n_blocks`` (rows shard them)."""
        return -(-n_blocks // self.q)

    def arena_shapes(self, n_blocks: int, n_slots: int = 1
                     ) -> List[Dict[str, Tuple]]:
        """name -> (shape, dtype) of every arena leaf, per pattern position:
        ``(G, n_blocks) + page shape`` for paged leaves, ``(G, n_slots) +
        slot shape`` for dense ones."""
        out: List[Dict[str, Tuple]] = []
        for e in self.entries:
            if isinstance(e, PagedSpec):
                out.append({name: ((self.groups, n_blocks) + shape, dt)
                            for name, (shape, dt) in e.leaves.items()})
            else:
                out.append({name: ((self.groups, n_slots) + shape, dt)
                            for name, shape, dt in e.leaves})
        return out

    def page_bytes(self) -> int:
        """Device bytes of ONE physical page across all paged layers (on a
        grid a page lives on one row, its heads spread over the r
        columns)."""
        return sum(self.groups * self.r * _nbytes(shape, dt)
                   for e in self.entries if isinstance(e, PagedSpec)
                   for shape, dt in e.leaves.values())

    def dense_slot_bytes(self) -> int:
        """Device bytes of ONE dense slot across all dense layers (on a
        grid its channels and heads spread over the r columns, and every
        grid row holds a replica: the JAX package's count)."""
        return sum(self.groups * self.q * self.r * _nbytes(shape, dt)
                   for e in self.entries if isinstance(e, DenseSpec)
                   for _, shape, dt in e.leaves)


def layer_state_specs(cfg: ModelConfig, plan=None, *, stride: int,
                      kvh: Optional[int] = None) -> ModelStateSpecs:
    """Derive the per-layer state contract from ``ModelConfig.pattern()``:
    ``attn`` -> :class:`PagedSpec`, ``mamba``/``ssm`` -> :class:`DenseSpec`.

    ``kvh`` is the stored kv-head count of the weights being served (see
    :func:`repro_torch.models.params.stored_heads`); it defaults to the
    config's native count.  With a grid ``plan`` (a
    :class:`repro_torch.partition.MeshPlan`) the specs are one PE's:
    ``kvh = kv_stored(r)[0] // r``, as the JAX grid stores them, and a
    mamba layer's slot holds its columns' channels and heads.  An
    encoder-decoder model has no spec: its
    cross caches are per request and sequence-shaped, neither pages nor
    O(1) slots, so it serves through the fixed-batch path
    (``serve/decode.py::make_decode_step``), as in the JAX package."""
    if cfg.enc_layers:
        raise NotImplementedError(
            "engine state specs: encoder cross caches are not paged or "
            "O(1)-dense; serve encdec models through the fixed-batch path")
    q = r = 1
    if plan is not None and plan.n_pes > 1:
        q, r = plan.grid_q, plan.grid_r
        if any(m == "attn" for m, _ in cfg.pattern()):
            kvh = cfg.kv_stored(r)[0] // r
    entries: List[StateSpec] = []
    for (mixer, _) in cfg.pattern():
        if mixer == "attn":
            entries.append(PagedSpec(
                kvh=kvh if kvh is not None else cfg.kv_stored(1)[0],
                hd=cfg.hd(), stride=stride, dtype=cfg.compute_dtype))
        elif mixer in ("mamba", "ssm"):
            entries.append(_mamba_dense_spec(cfg, r))
        else:
            raise NotImplementedError(
                f"no StateSpec mapping for mixer {mixer!r}")
    return ModelStateSpecs(entries=tuple(entries), groups=cfg.n_groups(),
                           q=q, r=r)
