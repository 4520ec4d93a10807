"""Nested containers of tensors (the JAX package's pytrees): dicts, lists,
tuples and NamedTuples (``OptState``) around tensor leaves.

Dicts are walked in sorted key order, as ``jax.tree_util`` walks them, so
the leaf order (and a sum over leaves) follows the JAX package's.  Paths
name each leaf as the JAX package's checkpoints do: a dict key, a sequence
index, or ``.field`` for a NamedTuple's field, joined with ``/``.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(path part, child)`` pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _rebuild(tree, items):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), items))
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); the same containers around the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, c, *(r[i] for r in rest))
                               for i, c in enumerate(tree)])
    return fn(tree, *rest)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, same containers."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    items = [map_with_path(fn, c, f"{prefix}/{p}" if prefix else p) for p, c in kids]
    return _rebuild(tree, items)


def leaves(tree) -> list:
    """The leaves in the JAX package's order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for _, c in kids for x in leaves(c)]


def paths(tree) -> list:
    """``(path, leaf)`` pairs in the JAX package's order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def unflatten(tree, new_leaves):
    """``tree``'s structure around ``new_leaves`` (in :func:`leaves` order)."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)
