"""Hand-written Hopper kernels of the port, one family per directory:
``csrc/`` CUDA sources, ``kernel.py`` build and binding, ``ref.py`` the
plain PyTorch version, ``ops.py`` the public op.

Every kernel wrapper and every plain version counts its calls in its
``launches`` attribute (some also per variant in ``by_variant``), and is
registered here with :func:`counted`.  A step captured as a CUDA graph
runs no Python when it is replayed, so the command queue reads the counts
around the capture (:func:`launch_counts`) and adds what the captured call
launched to every count at each replay (:func:`add_launches`): the counts
keep meaning "times the kernel ran".

A kernel with no backward refuses inputs that autograd would need a
gradient for (:func:`forbid_grad`): on the card it would return a tensor
with no history, and every gradient upstream of it would be silently
missing."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

# (launches, by_variant) of each counted wrapper
Counts = Dict[Callable, Tuple[int, Dict[str, int]]]

COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register ``fn`` as a counted wrapper; its ``launches`` starts at 0
    (its ``by_variant`` counts, where it has them, are its own)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> Counts:
    """The counts of every registered wrapper, copied."""
    return {fn: (fn.launches, dict(getattr(fn, "by_variant", {})))
            for fn in COUNTED}


def count_delta(before: Counts, after: Counts) -> Counts:
    """What changed from ``before`` to ``after``, wrappers that did not
    move left out."""
    delta = {}
    for fn, (n, var) in after.items():
        n0, var0 = before.get(fn, (0, {}))
        dvar = {k: v - var0.get(k, 0) for k, v in var.items()
                if v != var0.get(k, 0)}
        if n != n0 or dvar:
            delta[fn] = (n - n0, dvar)
    return delta


def add_launches(delta: Counts, sign: int = 1) -> None:
    """Add ``delta`` (times ``sign``) to the registered counts."""
    for fn, (n, var) in delta.items():
        fn.launches += sign * n
        for k, v in var.items():
            fn.by_variant[k] += sign * v


def forbid_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` naming ``name`` when grad mode is on and one
    of ``tensors`` requires grad: the op's CUDA kernel is forward only.
    Callers that need a gradient go through an op with a backward (the
    grouped GEMM's autograd functions), or run the op under
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; its output would carry no history and the gradients "
            f"upstream would be silently missing (call it under "
            f"torch.no_grad(), or use an op with a backward)")
