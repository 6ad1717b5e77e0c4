"""Nested containers of tensors: flatten, map and rebuild.

The port keeps the reference's pytrees as plain Python containers — a
model's parameters are a nested dict whose layout and key paths are those
of ``repro.models.model.init_params``, and a train state is a dataclass
of such trees — so names, orders and checkpoints carry across one to one.
These helpers walk them as ``jax.tree_util`` does:

* a dict's children are its values in sorted key order, named by key;
* a tuple's or list's are its items, named by index;
* a dataclass instance's are its fields in order, named by index (the
  reference registers ``TrainState`` with ``register_pytree_node``, whose
  key paths are flattened indices);
* ``None`` is an empty node (no leaf);
* anything else is a leaf.

A leaf's name is its key path joined by ``/``, as
``repro.checkpoint.manager._tree_paths`` names it.  ``is_leaf`` stops the
walk at a node it accepts, as ``jax.tree_util``'s does (the sharding
layer's axes trees hold per-dimension tuples of names as leaves), and
:func:`map` walks its further trees only as deep as the first, so a tree
of arrays pairs with an axes tree whose leaves are tuples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree: a node kind, its
    reconstruction data (dict keys, the dataclass type) and children."""

    kind: str  # leaf | none | dict | tuple | list | dataclass
    meta: Any = None
    children: Tuple["TreeDef", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


def _node(tree) -> Tuple[str, Any, list, list]:
    """(kind, meta, child names, children) of one node."""
    if tree is None:
        return "none", None, [], []
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), [str(k) for k in keys], \
            [tree[k] for k in keys]
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return kind, None, [str(i) for i in range(len(tree))], list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = dataclasses.fields(tree)
        return "dataclass", type(tree), [str(i) for i in range(len(fields))], \
            [getattr(tree, f.name) for f in fields]
    return "leaf", None, [], []


def _flatten(tree, prefix, names, leaves, is_leaf) -> TreeDef:
    if is_leaf is not None and is_leaf(tree):
        kind, meta, child_names, children = "leaf", None, [], []
    else:
        kind, meta, child_names, children = _node(tree)
    if kind == "leaf":
        names.append("/".join(prefix))
        leaves.append(tree)
        return TreeDef("leaf")
    return TreeDef(kind, meta, tuple(
        _flatten(c, prefix + (n,), names, leaves, is_leaf)
        for n, c in zip(child_names, children)))


def flatten_with_names(tree, is_leaf: Optional[Callable] = None
                       ) -> Tuple[List[str], list, TreeDef]:
    """(names, leaves, treedef), leaves in the reference's order."""
    names: List[str] = []
    leaves: list = []
    treedef = _flatten(tree, (), names, leaves, is_leaf)
    return names, leaves, treedef


def flatten(tree, is_leaf: Optional[Callable] = None
            ) -> Tuple[list, TreeDef]:
    _, leaves, treedef = flatten_with_names(tree, is_leaf)
    return leaves, treedef


def flatten_up_to(treedef: TreeDef, tree) -> list:
    """The subtrees of ``tree`` at ``treedef``'s leaf positions (``tree``
    must have ``treedef``'s structure down to them; below a leafless node
    of ``treedef`` it may hold anything, as ``jax.tree.map`` allows)."""
    out: list = []

    def walk(td: TreeDef, node):
        if td.kind == "leaf":
            out.append(node)
            return
        if td.num_leaves == 0:  # nothing to pair (an empty "rem" tuple)
            return
        kind, meta, _, children = _node(node)
        if kind != td.kind or meta != td.meta or \
                len(children) != len(td.children):
            raise ValueError("tree structures differ")
        for c, child in zip(td.children, children):
            walk(c, child)

    walk(treedef, tree)
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, leaves_) -> Any:
    """Rebuild ``treedef`` with ``leaves_`` in flatten order."""
    it = iter(leaves_)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.meta, kids))
        if td.kind == "tuple":
            return tuple(kids)
        if td.kind == "list":
            return kids
        return td.meta(*kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def map(fn: Callable, tree, *rest,  # noqa: A001 - jax.tree.map
        is_leaf: Optional[Callable] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (``tree``'s structure, or deeper below its leaves), rebuilt
    in ``tree``'s structure."""
    flat, treedef = flatten(tree, is_leaf)
    others = [flatten_up_to(treedef, other) for other in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def map_with_names(fn: Callable, tree) -> Any:
    """``fn(name, leaf)`` over the leaves of ``tree``."""
    names, flat, treedef = flatten_with_names(tree)
    return unflatten(treedef, [fn(n, x) for n, x in zip(names, flat)])
