"""Nested dicts of tensors as the JAX package's pytrees.

``jax.tree.leaves`` of a dict takes its keys in sorted order and skips an
empty dict (olmo's parameter-free LayerNorm); :func:`leaves` and
:func:`tree_map` walk a parameter dict the same way, so a sum over leaves
runs in the reference's order.
"""
from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, alike in
    structure), as a new tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in
    :func:`leaves`' order."""
    return _build(tree, iter(flat))


def _build(node, it):
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep ``flat`` (a step's gradients) alive
    # until the cycle collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)
