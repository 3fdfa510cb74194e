"""Nested parameter and state trees: dicts, lists and named tuples of
tensors, flattened in the JAX package's order.

``jax.tree_util`` visits a dict's keys sorted, a list in order and a named
tuple's fields in order, skips ``None``, and names each leaf by its path
(``['opt']/['m']/['embed']/.dense``).  The port's checkpoints are in the
JAX package's on-disk format, whose manifest lists the leaves in that
order under those names, so the port flattens the same way.  A
:class:`Pieces` tuple (the per-group parts of one stacked leaf) is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Node = Any


class Pieces(tuple):
    """The parts of one leaf along its first dim, in order (one leaf)."""


def _children(node: Node, is_leaf) -> Optional[List[Tuple[str, Node]]]:
    if is_leaf is not None and is_leaf(node):
        return None
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields
                if getattr(node, f) is not None]
    if isinstance(node, (list, tuple)) and not isinstance(node, Pieces):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Node, is_leaf: Optional[Callable] = None
                       ) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) in the JAX package's order; ``None`` has no leaf."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node, is_leaf)
        if kids is None:
            paths.append("/".join(path))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, path + [key])

    walk(tree, [])
    return paths, leaves


def leaves(tree: Node, is_leaf: Optional[Callable] = None) -> List[Any]:
    return flatten_with_paths(tree, is_leaf)[1]


def unflatten(like: Node, new: List[Any],
              is_leaf: Optional[Callable] = None) -> Node:
    """``like``'s structure with its leaves replaced, in order, by
    ``new``."""
    it = iter(new)

    def build(node):
        if node is None:
            return None
        if _children(node, is_leaf) is None:
            return next(it)
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if hasattr(node, "_fields"):
            return type(node)(*[build(getattr(node, f))
                                for f in node._fields])
        return type(node)(build(v) for v in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
