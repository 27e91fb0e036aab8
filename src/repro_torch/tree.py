"""Nested containers of tensors ("trees"), flattened the way ``jax.tree``
flattens them.

The LM side of the port keeps the reference's parameter, optimizer-state
and cache trees: dicts (entries in sorted key order), lists and tuples,
dataclasses (fields in declaration order) and ``None`` (an empty
subtree).  Everything else is a leaf, a subclass of ``tuple`` or
``list`` too (``distributed.sharding.PartitionSpec``), as in jax.  :func:`flatten_with_path` gives
each leaf jax's key-path string (``.params['stack'][0]['attn']['wq']``),
which is what a checkpoint stores, so a tree saved by either package
restores in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _children(node):
    """(kind, [(path suffix, child)]) of a container, or None for a leaf."""
    if isinstance(node, dict):
        return "dict", [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if type(node) in (list, tuple):
        return type(node), [(f"[{i}]", c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node), [(f".{f.name}", getattr(node, f.name))
                            for f in dataclasses.fields(node)]
    return None


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key-path string, leaf) for every leaf, in jax's flatten order."""
    if tree is None:
        return []
    ch = _children(tree)
    if ch is None:
        return [(prefix, tree)]
    out = []
    for suffix, child in ch[1]:
        out.extend(flatten_with_path(child, prefix + suffix))
    return out


def leaves(tree) -> list:
    return [x for _, x in flatten_with_path(tree)]


def map_structure(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and of the
    trees in ``rest`` (same structure), rebuilding ``tree``'s shape."""
    if tree is None:
        return None
    ch = _children(tree)
    if ch is None:
        return fn(tree, *rest)
    kind, items = ch
    if kind == "dict":
        return {k: map_structure(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if kind in (list, tuple):
        return kind(map_structure(fn, c, *(r[i] for r in rest))
                    for i, (_, c) in enumerate(items))
    return kind(**{f.name: map_structure(fn, getattr(tree, f.name),
                                         *(getattr(r, f.name) for r in rest))
                   for f in dataclasses.fields(tree)})


def unflatten_like(like, values: list):
    """A tree shaped like ``like`` whose leaves are ``values`` in flatten
    order."""
    it = iter(values)
    out = map_structure(lambda _x: next(it), like)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} values left over for the tree")
    return out
