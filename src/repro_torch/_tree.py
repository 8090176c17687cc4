"""Nested dicts, lists and tuples of tensors (the zoo's parameter trees):
their leaves in the JAX package's flatten order, and a map over trees of
one structure."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves in flatten order: dicts by sorted key, lists and tuples in
    order (a NamedTuple by its fields), as ``jax.tree.leaves`` orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)
