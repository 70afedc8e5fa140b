"""Nested trees of tensors: the parameter trees, optimizer states and
checkpoints of the training path.

A tree is a dict, a NamedTuple, a list or tuple of trees, None (a node
with no leaves) or a leaf.  Leaves come in `jax.tree`'s order — dict
keys sorted, NamedTuple fields and sequence items in order — so a leaf's
path ("opt/mu/blocks/attn/wq") and its place in the flat list are those
of the reference, and checkpoints cross between the packages.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(name, child) pairs in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


# The recursions below are module functions, not closures: a nested
# function that calls itself is a reference cycle, which would keep the
# list of leaves it appends to (a step's whole gradient, say) alive until
# the garbage collector runs.

def _walk(node: Any, prefix: tuple, sep: str, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((sep.join(prefix), node))
        return
    for name, child in kids:
        _walk(child, prefix + (name,), sep, out)


def flatten_with_path(tree: Any, sep: str = "/") -> list[tuple[str, Any]]:
    """[(path, leaf)] with the path's parts joined by `sep`."""
    out: list[tuple[str, Any]] = []
    _walk(tree, (), sep, out)
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """A tree of `template`'s structure holding `new_leaves` in leaf
    order."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _build(node: Any, it) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}  # the template's key order
    if _is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    columns = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*args) for args in zip(*columns)])
