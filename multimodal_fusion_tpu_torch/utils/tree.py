"""Nested containers of arrays.

The port's windows, device tables, batches and export specs are dicts of
dicts (and tuples) of arrays or tensors; these walk them.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested dicts, tuples and lists.  A None leaf
    stays None: ``fn`` is not called on it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
