"""Nested dicts, lists and tuples of tensors: the port's parameter trees.

The JAX package keeps params, optimizer state and RNN carries as pytrees and
walks them with ``jax.tree_util``; the port keeps the same structures and
walks them with these three functions.
"""

from __future__ import annotations


def tree_map(f, *trees):
    """``f`` over the leaves of one or more trees of the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> list:
    """The leaves in order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
