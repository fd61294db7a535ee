"""Trees of the port: nested dicts and lists (and tuples) of leaves.

The port's parameters, optimizer state and gradients are such trees, where
the reference's are JAX pytrees.  :func:`tree_leaves` lists the leaves in
JAX's order (dict keys sorted, sequences in order), so a reduction over
the leaves and a checkpoint's leaf numbering follow the reference's.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_structure"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's flattening order: dict keys sorted, lists and
    tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order).  It keeps no reference to ``leaves``: a
    recursive closure here would be a reference cycle holding the list
    (and every tensor in it) until the cyclic garbage collector ran."""
    leaves = list(leaves)
    n = len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    return _build(like, iter(leaves))


def _build(t, it):
    if isinstance(t, dict):
        out = dict.fromkeys(t)  # the caller's key order, filled sorted
        for k in sorted(t):
            out[k] = _build(t[k], it)
        return out
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_structure(tree) -> str:
    """A printable description of the tree's structure (leaves as ``*``)."""
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(tree_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"
