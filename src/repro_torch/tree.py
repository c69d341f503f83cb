"""Nested containers of tensors ("trees"): dicts, lists, tuples and
NamedTuples with tensors (or arrays) at the leaves, ``None`` an empty
subtree.  Dict keys are visited in sorted order and leaves are named by
their path as the reference package's key paths print it
(``"['a'].lam[0]"``), so a checkpoint's leaf names mean the same in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(path suffix, child) pairs of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def leaves_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    return [pair for suffix, child in children
            for pair in leaves_with_names(child, prefix + suffix)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_names(tree)]


def _rebuild(tree, values):
    """``tree`` with its leaves replaced, in order, from iterator
    ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(x, values) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values) for x in tree)
    return next(values)


def unflatten(template, values: list):
    """A tree of ``template``'s structure holding ``values`` as leaves."""
    n = len(leaves(template))
    if len(values) != n:
        raise ValueError(f"the template has {n} leaves, got {len(values)} "
                         f"values")
    return _rebuild(template, iter(values))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf across trees of one structure."""
    columns = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("tree_map needs trees of one structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
