"""The port's parameter trees: nested dicts, lists and tuples of tensors.

``tree_map`` walks several trees of one structure at once (a dict by its
keys, lists and tuples in order) and keeps the structure, as
``jax.tree.map`` does for the JAX package's pytrees; ``tree_leaves`` lists
the leaves in that walk's order.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``,
    which must have its structure; the result has it too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]
