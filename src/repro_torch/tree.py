"""Nested containers of tensors as the reference's JAX pytrees.

The training state is a tree: dicts (keys taken in sorted order, as JAX
flattens them), tuples and lists (by index), NamedTuples (by field name),
``None`` (no leaves), and anything else a leaf; a tuple whose type sets
``tree_leaf`` (the planner's partition spec ``P``) is a leaf too, as JAX's
``PartitionSpec`` is under ``is_leaf``. ``leaves_with_path`` walks
it in JAX's leaf order and gives each leaf the path JAX's
``tree_flatten_with_path`` gives it (dict key, field name or index), which
the checkpointer joins into file names and the optimizer's global norm
follows.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

__all__ = ["leaves_with_path", "leaves", "tree_map", "unflatten"]


def _is_leaf(tree: Any) -> bool:
    return getattr(type(tree), "tree_leaf", False)


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves_with_path(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in JAX's flattening order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, Mapping):
        return [item for key in sorted(tree)
                for item in leaves_with_path(tree[key], path + (key,))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in leaves_with_path(getattr(tree, name),
                                             path + (name,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, sub in enumerate(tree)
                for item in leaves_with_path(sub, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), into a tree of ``tree``'s
    structure."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` in leaf
    order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out
