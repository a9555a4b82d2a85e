"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

Leaf order follows ``jax.tree_util``: dict keys sorted, sequences in order.
Keeping that order means a leaf index here names the same parameter as in
``repro`` (the per-leaf launch count, ``params.py``'s carry-across, and the
tests all rely on it).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def tree_leaves(t) -> list:
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in tree_leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for c in t for x in tree_leaves(c)]
    return [t]


def tree_unflatten(like, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    return build(like)


def tree_map(f: Callable, t, *rest) -> Any:
    """Apply ``f`` leafwise over ``t`` and trees of the same structure."""
    cols = [tree_leaves(r) for r in rest]
    return tree_unflatten(t, [f(*xs) for xs in zip(tree_leaves(t), *cols)])
