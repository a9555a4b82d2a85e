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


def _rebuild(t, it):
    if isinstance(t, dict):
        out = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}  # keep the caller's key order
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(c, it) for c in t)
    return next(it)


def tree_unflatten(like, leaves) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (in ``tree_leaves``
    order).  A module-level recursion, not a nested function that calls
    itself: such a closure is a reference cycle that would keep ``leaves``
    (whole parameter trees on the card) alive until the cyclic garbage
    collector happens to run."""
    return _rebuild(like, iter(leaves))


def tree_map(f: Callable, t, *rest) -> Any:
    """Apply ``f`` leafwise over ``t`` and trees of the same structure."""
    cols = [tree_leaves(r) for r in rest]
    return tree_unflatten(t, [f(*xs) for xs in zip(tree_leaves(t), *cols)])


def copy_into(dst, src):
    """Write each leaf of ``src`` into the leaf of ``dst`` at its place (a
    leaf that already is ``dst``'s is left alone); returns ``dst``.  A
    single tensor is a tree of one leaf."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if s is not d:
            d.copy_(s)
    return dst


def tree_paths(t, prefix: str = "") -> list[str]:
    """Each leaf's key path in ``tree_leaves`` order, written as
    ``jax.tree_util.keystr`` writes it (``['params']['layers'][0]``)."""
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in tree_paths(t[k], f"{prefix}[{k!r}]")]
    if isinstance(t, (list, tuple)):
        return [p for i, c in enumerate(t) for p in tree_paths(c, f"{prefix}[{i}]")]
    return [prefix]
