"""Trees of the port: a tensor, or nested dicts of tensors (parameters,
optimizer states, batches).  Leaves come in ``jax.tree.leaves`` order
(sorted keys), so packing a tree matches the JAX package's."""
from __future__ import annotations

from typing import Mapping


def leaves(tree):
    """The tree's leaves, sorted key by key."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``tree`` with each leaf replaced by ``fn(leaf, *the matching leaves
    of rest)``."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, ``path`` the
    tuple of dict keys from the root to the leaf (the keys of JAX's
    ``tree_map_with_path`` paths)."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def unflatten(tree, values):
    """``tree``'s structure holding ``values`` (in ``leaves`` order)."""
    return _build(tree, iter(values))


def _build(tree, it):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would hold ``values`` (a step's gradients)
    # until the cyclic garbage collector runs
    if isinstance(tree, Mapping):
        return {k: _build(tree[k], it) for k in sorted(tree)}
    return next(it)
