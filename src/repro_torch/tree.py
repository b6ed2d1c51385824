"""Nested containers of tensors (the trainer's state, a model's
parameter tree) walked in `jax.tree_util`'s order: dict entries by
sorted key, list and tuple entries by index, a NamedTuple's fields in
declaration order; None is an empty subtree (no leaf). Anything else is
a leaf. The checkpoint store names a leaf by the "/"-join of its path
(dict keys, list indices, field names), as the reference's does."""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(path element, child)] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if _is_namedtuple(node):
        return type(node)(*values)
    return type(node)(values)


def _walk(node, prefix: str, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((prefix, node))
        return
    for k, v in kids:
        _walk(v, f"{prefix}/{k}" if prefix else k, out)


def tree_flatten_with_path(tree) -> list[tuple[str, Any]]:
    """[(path, leaf)] in traversal order; path is the "/"-join. (A
    module-level walk: a recursive closure would be a reference cycle
    holding the leaves until the garbage collector runs.)"""
    out: list = []
    _walk(tree, "", out)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of
    `rest`, which share its structure); None stays None."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, v, *(o[i][1] for o in others))
        for i, (_, v) in enumerate(kids)])


def tree_unflatten_like(template, leaves: list):
    """`template`'s structure with `leaves` in traversal order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
