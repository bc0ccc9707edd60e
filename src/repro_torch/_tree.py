"""Pytree helpers over dicts, lists and tuples, in ``jax.tree`` order.

Dicts flatten in sorted key order, lists and tuples in order, and
``None`` holds no leaf, exactly as ``jax.tree`` does, so int8 pages
written leaf by leaf in one package unflatten in the other.  Anything
else (tensors, numpy arrays, scalars, and a subclass of tuple such as
``sharding.logical.PartitionSpec``, as ``jax.tree`` keeps its own
``PartitionSpec``) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

# a treedef is None for a leaf, ("none",) for None, or
# (container kind, keys or length, child treedefs)
TreeDef = Any


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_flatten_with_path(tree: Any
                           ) -> Tuple[List[Tuple[Tuple[Any, ...], Any]],
                                      TreeDef]:
    """(path, leaf) pairs in tree order, a path being the dict keys and
    list or tuple indices down to its leaf
    (``jax.tree_util.tree_flatten_with_path``), and the treedef."""
    pairs: List[Tuple[Tuple[Any, ...], Any]] = []
    return pairs, _flatten(tree, (), pairs)


def _flatten(tree: Any, path: Tuple[Any, ...], pairs: list) -> TreeDef:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys),
                tuple(_flatten(tree[k], path + (k,), pairs) for k in keys))
    if type(tree) in (list, tuple):
        return (type(tree).__name__, len(tree),
                tuple(_flatten(x, path + (i,), pairs)
                      for i, x in enumerate(tree)))
    pairs.append((path, tree))
    return None


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("too many leaves for the treedef")
    return out


_END = object()


def _unflatten(treedef: TreeDef, it) -> Any:
    if treedef is None:
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("too few leaves for the treedef")
        return leaf
    kind = treedef[0]
    if kind == "none":
        return None
    children = [_unflatten(c, it) for c in treedef[2]]
    if kind == "dict":
        return dict(zip(treedef[1], children))
    return children if kind == "list" else tuple(children)


def tree_flatten_up_to(treedef: TreeDef, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` that sit where ``treedef`` has leaves
    (``treedef.flatten_up_to`` in jax)."""
    out: List[Any] = []

    def walk(td: TreeDef, node: Any) -> None:
        if td is None:
            out.append(node)
        elif td[0] == "dict":
            if sorted(node) != list(td[1]):
                raise ValueError(f"dict keys {sorted(node)} != {td[1]}")
            for k, c in zip(td[1], td[2]):
                walk(c, node[k])
        elif td[0] in ("list", "tuple"):
            if len(node) != td[1]:
                raise ValueError(f"length {len(node)} != {td[1]}")
            for c, x in zip(td[2], node):
                walk(c, x)

    walk(treedef, tree)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])
