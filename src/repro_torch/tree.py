"""Nested dicts and lists of tensors, walked in ``jax.tree_util``'s order.

The port keeps the JAX package's trees (parameters, optimizer state, train
state) as plain dicts and lists.  Dict keys are visited sorted and list
items in order, as ``jax.tree.leaves`` visits them, and a path prints as
``jax.tree_util.keystr`` prints it (``['layers'][0]['wq']``), so a leaf's
name and position are the same in both packages.  Anything that is not a
dict or a list (a tensor, an array, a shape tuple) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree) for pair in paths(tree[key], f"{prefix}['{key}']")]
    if isinstance(tree, list):
        return [pair for i, sub in enumerate(tree) for pair in paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def map(fn: Callable, tree, *rest):  # noqa: A001 - jax.tree.map's name
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure holding ``new_leaves`` (in :func:`leaves` order)."""
    it: Iterator = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _rebuild(tree, it: Iterator):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}  # the tree's own key order
    if isinstance(tree, list):
        return [_rebuild(sub, it) for sub in tree]
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree holds")
    return leaf
