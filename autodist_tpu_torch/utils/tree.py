"""Nested-container helpers with JAX's pytree conventions.

Params and batches are nested dicts / lists / tuples of tensors or arrays.
Flattening follows ``jax.tree_util``: dict keys in sorted order, ``None``
an empty subtree, plain lists and tuples nodes, anything else (tuple
subclasses included) a leaf. Keeping JAX's order makes variable
lists, fusion-group ids and strategy node configs come out identical in
both packages.
"""
from collections import namedtuple

DictKey = namedtuple("DictKey", ["key"])
SequenceKey = namedtuple("SequenceKey", ["idx"])


class TreeDef:
    """Structure of a flattened tree; two trees match when these are equal."""

    def __init__(self, kind, meta, children):
        self.kind = kind          # "leaf" | "none" | "dict" | "list" | "tuple"
        self.meta = meta          # sorted dict keys, else None
        self.children = children  # tuple of TreeDef

    def _key(self):
        return (self.kind, self.meta, tuple(c._key() for c in self.children))

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        return f"[{inner}]" if self.kind == "list" else f"({inner})"


_LEAF = TreeDef("leaf", None, ())


def flatten_with_path(tree, path=()):
    """``([(path, leaf), ...], treedef)`` with paths of DictKey/SequenceKey."""
    if tree is None:
        return [], TreeDef("none", None, ())
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        out, defs = [], []
        for k in keys:
            sub, d = flatten_with_path(tree[k], path + (DictKey(k),))
            out += sub
            defs.append(d)
        return out, TreeDef("dict", keys, tuple(defs))
    if type(tree) in (list, tuple):  # subclasses (PartitionSpec) are leaves
        out, defs = [], []
        for i, x in enumerate(tree):
            sub, d = flatten_with_path(x, path + (SequenceKey(i),))
            out += sub
            defs.append(d)
        kind = "list" if type(tree) is list else "tuple"
        return out, TreeDef(kind, None, tuple(defs))
    return [(path, tree)], _LEAF


def flatten(tree):
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree):
    return flatten(tree)[0]


def unflatten(treedef, leaves_):
    it = iter(leaves_)

    def build(d):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        return kids if d.kind == "list" else tuple(kids)
    return build(treedef)


def tree_map(fn, tree):
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])


def tree_map_with_path(fn, tree):
    pairs, treedef = flatten_with_path(tree)
    return unflatten(treedef, [fn(p, x) for p, x in pairs])


def path_to_name(path):
    """Render a key path as a '/'-joined logical variable name."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)
