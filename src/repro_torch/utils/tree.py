"""Helpers over parameter trees: nested dicts (and lists / tuples) of tensors.

The port's counterpart of ``repro.utils.tree``.  A leaf's name is its path
of keys (or list / tuple positions) joined by "/"; dict keys are visited in
sorted order, as JAX flattens dicts.  A named tuple (``train.TrainState``)
is a tuple of its fields, as the reference's pytree nodes flatten to their
children; ``None`` holds no leaf.
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
        out = [tree_map_with_path_names(fn, v, _join(prefix, i)) for i, v in enumerate(tree)]
        return tree._make(out) if hasattr(tree, "_make") else type(tree)(out)
    return tree if tree is None else fn(prefix, tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` and the leaves at the same paths of
    each tree of ``rest`` (which must have ``tree``'s nesting)."""
    others = [dict(named_leaves(r)) for r in rest]
    return tree_map_with_path_names(lambda name, leaf: fn(leaf, *(o[name] for o in others)),
                                    tree)


def tree_param_count(tree: Any) -> int:
    """Total number of elements over every leaf."""
    return sum(leaf.numel() for _, leaf in named_leaves(tree))


def tree_size_bytes(tree: Any) -> int:
    """Total bytes over every leaf (elements × element size)."""
    return sum(leaf.numel() * leaf.element_size() for _, leaf in named_leaves(tree))
