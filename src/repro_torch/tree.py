"""Nested dict/list parameter trees: flatten, unflatten and map, with paths.

Parameter trees are plain nested dicts and lists whose leaves are tensors
(or numpy arrays, or any other non-container object). Dicts flatten in
SORTED key order, lists and tuples in index order: exactly the order
``jax.tree_util`` uses. Everything that serializes a tree depends on it:
the skeleton's flat-buffer layout, the store's file bytes and the
``LayerInfo`` rows of the planner, so a unit written by either package
has the same layout.

``None`` is an empty subtree (no leaves), as in JAX. A path is the tuple
of keys from the root to a leaf: ``str`` keys for dicts, ``int`` indices
for lists and tuples.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_flatten_with_path",
           "tree_unflatten", "tree_leaves", "tree_map", "keystr"]

Path = Tuple[Any, ...]


class _Leaf:
    """Placeholder for a leaf inside a :class:`TreeDef` template."""
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


class TreeDef:
    """The structure of a tree with its leaves taken out."""
    __slots__ = ("template", "num_leaves")

    def __init__(self, template: Any, num_leaves: int):
        self.template = template
        self.num_leaves = num_leaves

    def __repr__(self) -> str:
        return f"TreeDef({self.template!r})"


# The walkers are module functions, not closures: a nested function that
# calls itself sits in a reference cycle with its cells, which would keep
# the leaves (device tensors of swapped-out blocks) alive until the cyclic
# garbage collector happens to run.
def _walk(node, path, is_leaf, out):
    if is_leaf is not None and is_leaf(node):
        out.append((path, node))
        return _LEAF
    if isinstance(node, dict):
        return {k: _walk(node[k], path + (k,), is_leaf, out)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        kids = [_walk(v, path + (i,), is_leaf, out)
                for i, v in enumerate(node)]
        return kids if isinstance(node, list) else tuple(kids)
    if node is None:
        return None
    out.append((path, node))
    return _LEAF


def _build(t, it):
    if t is _LEAF:
        return next(it)
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if isinstance(t, list):
        return [_build(v, it) for v in t]
    if isinstance(t, tuple):
        return tuple(_build(v, it) for v in t)
    return None


def tree_flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                           ) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in JAX's leaf order."""
    out: List[Tuple[Path, Any]] = []
    template = _walk(tree, (), is_leaf, out)
    return out, TreeDef(template, len(out))


def tree_flatten(tree, is_leaf=None) -> Tuple[list, TreeDef]:
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`tree_flatten`; dicts come back in sorted key order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"tree_unflatten: {treedef.num_leaves} leaves "
                         f"expected, got {len(leaves)}")
    return _build(treedef.template, iter(leaves))


def tree_map(fn: Callable, tree, is_leaf=None) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def keystr(path: Path) -> str:
    """``['attn']['wq']`` style rendering of a path (JAX's ``keystr``)."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)
