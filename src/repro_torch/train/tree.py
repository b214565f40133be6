"""Trees of the training state in the reference's leaf order.

``jax.tree_util`` flattens a dict in sorted key order, a list or tuple in
index order, a registered node (``TrainState``, ``AdamWState``) in its
children's order, and ``None`` as an empty subtree.  The checkpoint's
leaf keys ("0/dec/scan/b0/mix/wq", ...) and the global norm's summation
order follow that order here, so the port's files carry the reference's
keys and its sums run in the reference's order.  A dataclass is a node
whose children are its fields in order, keyed by index as the
reference's registered nodes are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs of an inner node in the reference's order, or
    ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def key_paths(tree) -> list[tuple[str, Any]]:
    """``[(key, leaf), ...]``: each leaf under its path joined by "/", in
    ``jax.tree_util.tree_flatten_with_path``'s order."""
    out: list[tuple[str, Any]] = []
    _walk(tree, (), out)
    return out


def _walk(node, prefix, out) -> None:
    # a module-level function: a nested recursive one would sit in a
    # reference cycle with ``out`` and keep every leaf alive until the
    # garbage collector runs
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(prefix), node))
        return
    for k, child in kids:
        _walk(child, prefix + (str(k),), out)


def map_with_keys(fn: Callable[[str, Any], Any], tree, prefix=()):
    """The tree with each leaf replaced by ``fn(key, leaf)``; the
    structure (dict insertion order, dataclass types) is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [map_with_keys(fn, v, prefix + (str(i),))
                for i, v in enumerate(tree)]
        return type(tree)(kids)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(map_with_keys(fn, getattr(tree, f.name),
                                          prefix + (str(i),))
                            for i, f in enumerate(dataclasses.fields(tree))))
    return fn("/".join(prefix), tree)
