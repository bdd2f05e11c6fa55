"""Leaves of a training-state tree in JAX's pytree order.

Dicts are nodes with their keys sorted, lists and tuples (named tuples
included) nodes with their items in order; anything else is a leaf. This
is the order ``jax.tree.flatten`` gives the reference's ``TrainState``,
so the optimizer and the grad norm visit leaves in the reference's order
and a checkpoint's ``leaf_%05d.npy`` files mean the same leaves in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "unflatten", "leaves", "tree_map"]


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``unflatten(treedef, leaves)`` rebuilds."""
    out: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t), None, [walk(x) for x in t])
        out.append(t)
        return None

    return out, walk(tree)


def unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        items = [build(k) for k in kids]
        if kind is dict:
            return dict(zip(keys, items))
        if kind in (list, tuple):
            return kind(items)
        return kind(*items)  # a named tuple

    return build(treedef)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, rebuilt with its structure."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])
