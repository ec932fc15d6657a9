"""Helpers over parameter trees: nested dicts (and lists / tuples) of tensors.

The port's counterpart of ``repro.utils.tree``.  A leaf's name is its path
of keys (or list positions) joined by "/"; dict keys are visited in sorted
order, as JAX flattens dicts.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield (slash/joined/path, leaf) for every leaf in the tree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], _join(prefix, key))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, _join(prefix, i))
    elif tree is not None:
        yield prefix, tree


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree: Any,
                             prefix: str = "") -> Any:
    """The tree with every leaf replaced by fn(path_name, leaf); the nesting
    (and dict key order) is kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path_names(fn, v, _join(prefix, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path_names(fn, v, _join(prefix, i))
                          for i, v in enumerate(tree))
    return tree if tree is None else fn(prefix, tree)
