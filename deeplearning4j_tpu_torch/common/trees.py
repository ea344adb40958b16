"""Nested dicts, lists and tuples of tensors: the port's parameter trees.

The JAX package keeps params, optimizer state and RNN carries as pytrees and
walks them with ``jax.tree_util``; the port keeps the same structures and
walks them with these three functions. An object with ``tree_flatten`` /
``tree_unflatten`` (``quantize.QuantizedTensor``) is a node, as a
registered pytree node is in the JAX package: the functions walk its
children and rebuild it around them.
"""

from __future__ import annotations


def _is_node(t) -> bool:
    return hasattr(t, "tree_flatten")


def tree_map(f, *trees):
    """``f`` over the leaves of one or more trees of the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *xs) for xs in zip(*trees))
    if _is_node(t0):
        children, aux = t0.tree_flatten()
        others = [t.tree_flatten()[0] for t in trees[1:]]
        return type(t0).tree_unflatten(aux, [
            tree_map(f, *xs) for xs in zip(children, *others)])
    return f(*trees)


def tree_leaves(tree) -> list:
    """The leaves in order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    if _is_node(tree):
        return tree_leaves(list(tree.tree_flatten()[0]))
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
