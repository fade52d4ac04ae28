"""The few tree operations the training substrate needs, over nested dicts,
lists and tuples of tensors (the port's params), in `jax.tree`'s leaf order:
dict keys sorted, sequences in order.  `None` is an empty subtree."""
from __future__ import annotations

import typing

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path", "tree_unflatten"]


def tree_map(fn: typing.Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, typing.Any]]:
    """[(path, leaf)] with the path as a tuple of dict keys and list indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves_with_path(tree[k], (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in tree_leaves_with_path(t, (*prefix, i))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves: typing.Iterable):
    """A tree shaped like `like` holding `leaves`, given in `tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(n) for n in node)
        return next(it)

    return build(like)
