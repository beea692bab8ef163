"""Flatten and rebuild the port's state trees (the counterpart of the
``jax.tree_util`` calls the serving layer makes).

One walker serves every consumer: the engine's swap check compares two
states' structures and leaves, the lifecycle's finite scan and the fault
injectors read the leaves, and the checkpoint writes them by path and
rebuilds a tree from a template's structure.

Nodes and what they contribute:

* ``None``: no leaves (an empty subtree, as in JAX);
* NamedTuples, by field (``.field`` paths);
* dataclasses (the indexes), by field; a field holding a bool, int, float
  or str is static configuration (an IVF index's ``nprobe``, a graph's
  ``beam``) and enters the structure with its value, not the leaves;
* dicts, by sorted key (``['key']``), lists and tuples, by position
  (``[i]``);
* a host rerank store (:mod:`repro_torch.core.rerank_tier`): no leaves; it
  enters the structure whole and is compared by (type, shape, dtype), so a
  store with new rows keeps the structure and one with another shape does
  not;
* anything else is a leaf: tensors, numpy arrays, python scalars.

Paths are those of ``jax.tree_util.keystr`` for the same structure, so a
checkpoint manifest reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

__all__ = ["TreeDef", "flatten", "flatten_with_paths", "unflatten",
           "structure", "leaves"]

_STATIC = (bool, int, float, str)
_LEAF = ("*",)


def _is_host_store(obj) -> bool:
    from repro_torch.core.rerank_tier import host_store
    return host_store(obj) is not None


class TreeDef:
    """The structure of a tree: node kinds, classes, static values and
    host stores, without its leaves. Equal structures unflatten the same
    leaf list into trees of the same shape."""

    __slots__ = ("node",)

    def __init__(self, node):
        self.node = node

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.node == other.node

    def __hash__(self):
        return hash(self.node)

    def __repr__(self):
        return f"TreeDef({_describe(self.node)})"

    def unflatten(self, leaves):
        it = iter(leaves)
        out = _build(self.node, it)
        rest = sum(1 for _ in it)
        if rest:
            raise ValueError(f"{rest} leaves left over after unflatten")
        return out


def _describe(node) -> str:
    kind = node[0]
    if kind == "*":
        return "*"
    if kind == "none":
        return "None"
    if kind == "host":
        return repr(node[1])
    if kind in ("list", "tuple"):
        inner = ", ".join(_describe(c) for c in node[2])
        return f"[{inner}]" if kind == "list" else f"({inner})"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(c)}"
                               for k, c in zip(node[1], node[2])) + "}"
    cls = node[1][0] if kind == "dataclass" else node[1]
    names = node[1][1] if kind == "dataclass" else cls._fields
    fields = [f"{n}={_describe(c)}" for n, c in zip(names, node[2])]
    if kind == "dataclass":
        fields += [f"{n}={v!r}" for n, v in node[1][2]]
    return f"{cls.__name__}({', '.join(fields)})"


def _walk(obj, path: str, out: List[Tuple[str, Any]]):
    if obj is None:
        return ("none",)
    if _is_host_store(obj):
        return ("host", obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        kids = tuple(_walk(getattr(obj, f), f"{path}.{f}", out)
                     for f in obj._fields)
        return ("namedtuple", type(obj), kids)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names, static, kids = [], [], []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, _STATIC):
                static.append((f.name, (type(v).__name__, v)))
            else:
                names.append(f.name)
                kids.append(_walk(v, f"{path}.{f.name}", out))
        return ("dataclass", (type(obj), tuple(names), tuple(static)),
                tuple(kids))
    if isinstance(obj, dict):
        keys = tuple(sorted(obj))
        kids = tuple(_walk(obj[k], f"{path}[{k!r}]", out) for k in keys)
        return ("dict", keys, kids)
    if isinstance(obj, (list, tuple)):
        kids = tuple(_walk(v, f"{path}[{i}]", out) for i, v in enumerate(obj))
        return ("list" if isinstance(obj, list) else "tuple", len(obj), kids)
    out.append((path, obj))
    return _LEAF


def _build(node, it):
    kind = node[0]
    if kind == "*":
        return next(it)
    if kind == "none":
        return None
    if kind == "host":
        return node[1]
    kids = [_build(c, it) for c in node[2]]
    if kind == "namedtuple":
        return node[1](*kids)
    if kind == "dataclass":
        cls, names, static = node[1]
        kwargs = dict(zip(names, kids))
        kwargs.update({n: v for n, (_, v) in static})
        return cls(**kwargs)
    if kind == "dict":
        return dict(zip(node[1], kids))
    return kids if kind == "list" else tuple(kids)


def flatten_with_paths(tree) -> Tuple[List[str], List[Any], TreeDef]:
    """``(paths, leaves, treedef)`` in a fixed order (fields in order,
    dict keys sorted)."""
    out: List[Tuple[str, Any]] = []
    node = _walk(tree, "", out)
    return [p for p, _ in out], [v for _, v in out], TreeDef(node)


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    _, leaves_, treedef = flatten_with_paths(tree)
    return leaves_, treedef


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def structure(tree) -> TreeDef:
    return flatten(tree)[1]


def unflatten(treedef: TreeDef, leaves_) -> Any:
    return treedef.unflatten(leaves_)
