"""Nested containers of tensors as the reference's pytrees see them.

The reference flattens its state, caches and shardings with
``jax.tree_util``: dicts by sorted key, named tuples and tuples by
position, ``None`` as an empty node, anything else a leaf.  The port
keeps the same containers (dicts of tensors, the caches' named tuples,
``TrainState``), and these helpers walk them in that order, so that a
leaf's path, a checkpoint's file name and a list of fallbacks come out
as the reference's do.  A path is a tuple of keys: ``("dict", key)``,
``("attr", field)`` (a named tuple's field) or ``("index", i)``.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list | None:
    """``[(key, child)]`` of a container in the reference's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(("dict", k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(("attr", f), v) for f, v in zip(node._fields, node)]
    if isinstance(node, (tuple, list)):
        return [(("index", i), v) for i, v in enumerate(node)]
    return None


def _child(node, key):
    kind, k = key
    return getattr(node, k) if kind == "attr" else node[k]


def leaves_with_path(tree, *rest, is_leaf: Callable | None = None) -> list:
    """``[(path, leaf, *rest_nodes)]`` in the reference's flatten order;
    ``rest`` are trees with ``tree``'s structure up to its leaves (their
    nodes at ``tree``'s leaf positions come whole, as the reference's
    ``flatten_up_to`` gives them)."""
    out: list = []

    def walk(node, others, path):
        if node is None:
            return
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            out.append((path, node, *others))
            return
        for key, child in kids:
            walk(child, [_child(o, key) for o in others], path + (key,))

    walk(tree, list(rest), ())
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None,
             with_path: bool = False) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf, *rest_nodes)`` (or
    ``fn(path, leaf, *rest_nodes)``); containers keep their types."""

    def walk(node, others, path):
        if node is None:
            return None
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            return fn(path, node, *others) if with_path \
                else fn(node, *others)
        new = {key: walk(child, [_child(o, key) for o in others],
                         path + (key,)) for key, child in kids}
        if isinstance(node, dict):
            return {k: new[("dict", k)] for k in node}
        if hasattr(node, "_fields"):
            return type(node)(*(new[("attr", f)] for f in node._fields))
        return type(node)(new[("index", i)] for i in range(len(node)))

    return walk(tree, list(rest), ())


def keystr(path: tuple) -> str:
    """The reference's ``jax.tree_util.keystr`` of a path:
    ``.field['key'][0]``."""
    parts = []
    for kind, k in path:
        parts.append(f".{k}" if kind == "attr" else f"[{k!r}]")
    return "".join(parts)


def nest(flat: dict) -> dict:
    """``{"a.b.c": v}`` -> ``{"a": {"b": {"c": v}}}`` (the port's dotted
    leaves as the reference's nested parameter tree)."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        *head, last = name.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def is_axes(x) -> bool:
    """A logical-axes tuple (names or None), a leaf of an axes tree."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(a, str) or a is None for a in x)
