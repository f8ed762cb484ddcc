"""Nested dicts of tensors as trees, flattened in the reference's order.

``jax.tree`` flattens a dict by its sorted keys; these helpers walk the
port's parameter and training-state trees in that same order, so a global
norm sums its leaves in the reference's order and a checkpoint names its
leaves as ``repro.checkpoint`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted-key order; a list or tuple is a
    node whose keys are its indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on the matching leaves of trees of one structure, called in
    sorted-key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """The inverse of ``leaves``: ``flat`` in the structure of ``like``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)
