"""Nested dict/list/tuple trees of tensors, walked in ``jax.tree``'s order.

Dict keys are visited sorted, lists and tuples by index, and ``None`` and
empty containers hold no leaf, as in ``jax.tree_util``. The CPSL state,
the optimizers and the checkpointer share these helpers, so a state tree
flattens to the same leaf sequence and path strings in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]``; a path is the tuple of keys and indices."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(flatten_with_path(v, prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map(fn: Callable, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    """Apply ``fn`` leaf-wise over trees of one structure, in flatten
    order (dicts come back with their keys sorted, as in jax)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten_like(target, new_leaves):
    """The structure of ``target`` holding ``new_leaves`` in flatten order."""
    it = iter(new_leaves)
    out = map(lambda _: next(it), target)
    rest = list(it)
    assert not rest, f"{len(rest)} leaves left over"
    return out


def unbind(tree) -> list:
    """The slices of every leaf along its leading axis, as a list of trees
    (slice i of every leaf in tree i). Each leaf is unbound once, so in
    backward one node stacks the slices' gradients, where indexing slice by
    slice would add one full-size zero tensor per slice."""
    parts = [leaf.unbind(0) for leaf in leaves(tree)]
    n = len(parts[0]) if parts else 0
    return [unflatten_like(tree, [p[i] for p in parts]) for i in range(n)]
