"""Live and peak device bytes of a program, followed op by op.

:class:`MemTracker` is a ``TorchDispatchMode``: every storage that an op
makes is added to the live bytes when it is first seen (its ``nbytes``),
and subtracted when it is freed (``weakref.finalize`` on the storage,
which PyTorch keeps as one Python object for the storage's life).  Views
share their base's storage and add nothing.  The peak of the live bytes
is kept, and what was resident when the tracker opened (weights, optimizer
moments, a cache, the batch) is counted from the start.

On the meta device nothing is computed, but every allocation the program
makes is made: its remat, its fp32 upcasts, its chunked cross-entropy,
its in-place updates and the storages its kernel wrappers allocate (the
grouped GEMM's meta route, ``kernels/grouped_mm/ops.py``).  So the peak
is the program's own, not a formula.  What it cannot see: the caching
allocator's rounding and its pools, library workspaces (cuBLAS) and the
temporary storage of ops that allocate inside a kernel (sorts); the
card's ``torch.cuda.max_memory_allocated`` counts those
(``launch/dryrun.py --verify`` holds the two against each other).

On the meta device most ops' shape functions are Python, a few hundred
microseconds each, and a step repeats the same ops on the same shapes
(every layer group; AdamW's update slices).  So an op on meta tensors
that returns fresh tensors (it mutates nothing and its results alias no
input) runs its meta kernel once per signature (the op, every tensor
argument's shape, strides and dtype, every other argument); a later call
of the signature allocates the same results with ``empty_strided``.  A
result whose storage is not exactly what ``empty_strided`` would make is
never reused.  Only the time changes: the tensors, and so the live bytes,
are the ones the kernel makes.  A mode entered after the tracker (the FLOP
counter) sees every op before it.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Hashable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

META = torch.device("meta")


class MemTracker(TorchDispatchMode):
    """``with MemTracker(params, opt_state, batch) as mt: step(...)`` ->
    ``mt.peak`` bytes (resident included), ``mt.live`` at the end,
    ``mt.resident`` at the start.  Only storages on the first resident
    tensor's device count; host constants do not."""

    def __init__(self, *resident: Any):
        super().__init__()
        self._results: Dict[Hashable, Any] = {}
        self.device = next(t.device for tree in resident
                           for t in tensors(tree))
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        for tree in resident:
            for t in tensors(tree):
                self._see(t)
        self.resident = self.live

    def _see(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _signature(func, args, kwargs)
        made = self._results.get(key) if key is not None else None
        if made is not None:
            spec, leaves = made
            out = tree_unflatten([
                torch.empty_strided(x[0], x[1], dtype=x[2], device=META)
                if isinstance(x, tuple) else x for x in leaves], spec)
        else:
            out = func(*args, **kwargs)
            if key is not None:
                self._keep(key, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._see(t)
        return out

    def _keep(self, key: Hashable, out: Any) -> None:
        """Remember ``out``'s results when ``empty_strided`` remakes them
        exactly: fresh meta storages of the least size."""
        leaves, spec = tree_flatten(out)
        kept = []
        for t in leaves:
            if isinstance(t, torch.Tensor):
                if t.device != META or t.storage_offset() or \
                        t.untyped_storage().nbytes() != _least(t):
                    return
                kept.append((tuple(t.shape), t.stride(), t.dtype))
            elif isinstance(t, (int, float, bool, type(None))):
                kept.append(t)
            else:
                return
        self._results[key] = (spec, kept)


def _least(t: torch.Tensor) -> int:
    """Bytes of the least storage that holds ``t``'s elements."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return span * t.element_size()


def _signature(func, args, kwargs) -> Optional[Hashable]:
    """The key of a call whose results may be reused, or None: the op
    mutates nothing, its results alias nothing, every tensor argument
    lies on the meta device and every other argument is hashable."""
    schema = func._schema
    if schema.is_mutable or any(r.alias_info is not None
                                for r in schema.returns):
        return None
    try:
        return (func, _key(args), _key(tuple(sorted(kwargs.items()))))
    except (TypeError, _NotMeta):
        return None


class _NotMeta(Exception):
    pass


def _key(x) -> Hashable:
    if isinstance(x, torch.Tensor):
        if x.device != META:
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_key(v) for v in x))
    hash(x)                     # TypeError: not a key
    return (type(x), x)


def tensors(tree: Any):
    """Every tensor of a tree of dicts, lists, tuples and named tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
