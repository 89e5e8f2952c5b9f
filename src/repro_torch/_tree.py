"""Trees of tensors in the reference's flatten order.

The reference's optimizer, checkpoints and sharding rules walk pytrees
with `jax.tree_util`: dict entries in sorted key order, lists and tuples
in order, NamedTuple fields in order, ``None`` an empty subtree, anything
else (a tensor, a number, a tuple subclass such as a partition spec) a
leaf. A leaf's path is a tuple of `DictKey` / `GetAttrKey` /
`SequenceKey` entries, and `keystr` spells it as `jax.tree_util.keystr`
does (``.opt.mu['units'][0]['moe']['wo']``). The port's global norm sums
the leaves in this order and its checkpoints carry these strings, so both
packages sum alike and read each other's checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class DictKey(NamedTuple):
    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class GetAttrKey(NamedTuple):
    name: str

    def __str__(self) -> str:
        return f".{self.name}"


class SequenceKey(NamedTuple):
    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(key, child)] of a container in flatten order, or None for a leaf."""
    if isinstance(node, dict):
        return [(DictKey(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(GetAttrKey(f), getattr(node, f)) for f in node._fields]
    if type(node) in (list, tuple):
        return [(SequenceKey(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's flatten order."""
    out: list = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, path + (key,))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def keystr(path) -> str:
    return "".join(str(k) for k in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every leaf of ``tree`` (and the leaves at the same place
    in ``rest``, which share its structure); the containers rebuilt as
    they are."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, _path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *[r[k] for r in rest],
                                      _path=_path + (DictKey(k),))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[
            tree_map_with_path(fn, getattr(tree, f),
                               *[getattr(r, f) for r in rest],
                               _path=_path + (GetAttrKey(f),))
            for f in tree._fields])
    if type(tree) in (list, tuple):
        vals = [tree_map_with_path(fn, v, *[r[i] for r in rest],
                                   _path=_path + (SequenceKey(i),))
                for i, v in enumerate(tree)]
        return type(tree)(vals)
    return fn(_path, tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves, in flatten order, replaced
    by ``new_leaves``."""
    def ident(path):
        return tuple((type(k).__name__, k[0]) for k in path)

    index = {ident(p): i for i, (p, _) in
             enumerate(flatten_with_path(like))}
    vals = list(new_leaves)
    if len(vals) != len(index):
        raise ValueError(f"{len(vals)} leaves for a tree of {len(index)}")
    return tree_map_with_path(lambda p, _: vals[index[ident(p)]], like)
