"""Payload flattening for the connectors: the subset of pytree semantics
the stage payloads use.

Containers are ``dict`` (children in sorted-key order), ``list`` and
``tuple``; ``None`` is an empty container, so a payload such as the
Talker's ``{"tokens": arr, "hidden": None}`` flattens to one leaf and
rebuilds with its ``None`` in place.  Everything else (arrays, numbers,
strings) is a leaf.
"""
from __future__ import annotations

from typing import Any, List, Tuple

# a tree definition is ("leaf",), ("none",), ("list"|"tuple", children)
# or ("dict", keys, children)
TreeDef = Tuple[Any, ...]

_LEAF: TreeDef = ("leaf",)
_NONE: TreeDef = ("none",)


def flatten(payload: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    return leaves, _flatten(payload, leaves)


def _flatten(node: Any, leaves: List[Any]) -> TreeDef:
    if node is None:
        return _NONE
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_flatten(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, [_flatten(c, leaves) for c in node])
    leaves.append(node)
    return _LEAF


def unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _NONE) is not _NONE:
        raise ValueError("more leaves than the tree definition holds")
    return out


def _build(td: TreeDef, it) -> Any:
    kind = td[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    children = [_build(c, it) for c in td[1]]
    return children if kind == "list" else tuple(children)


def leaves(payload: Any) -> List[Any]:
    return flatten(payload)[0]
