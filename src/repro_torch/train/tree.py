"""Nested containers of tensors in ``jax.tree_util``'s order.

Parameters, optimizer state and checkpoints are plain nested dicts (and
tuples) of tensors.  Their leaves are visited as ``jax.tree_util`` visits a
pytree: dict keys sorted at every level, tuples and lists in order, None an
empty subtree.  That order is the checkpoint format's (``leaf_<i>``), so a
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _children(tree):
    """(kind, keys) of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return "dict", sorted(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, range(len(tree))
    return None


def _iter_leaves(tree) -> Iterator[Any]:
    if tree is None:
        return
    node = _children(tree)
    if node is None:
        yield tree
        return
    for k in node[1]:
        yield from _iter_leaves(tree[k])


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree_util.tree_leaves``' order."""
    return list(_iter_leaves(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``, leaves
    visited in sorted-key order; dicts keep ``tree``'s key order."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    done = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in node[1]}
    if node[0] == "dict":
        return {k: done[k] for k in tree}
    return type(tree)(done[i] for i in range(len(tree)))


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the same nesting
    (the checkpoint manifest's ``treedef``)."""

    def one(t) -> str:
        if t is None:
            return "None"
        node = _children(t)
        if node is None:
            return "*"
        if node[0] == "dict":
            return "{" + ", ".join(f"{k!r}: {one(t[k])}" for k in node[1]) + "}"
        inner = ", ".join(one(c) for c in t)
        if node[0] == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(t) == 1 else f"({inner})"

    return f"PyTreeDef({one(tree)})"
