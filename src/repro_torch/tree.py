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


def unflatten(tree, values):
    """``tree``'s structure holding ``values`` (in ``leaves`` order)."""
    it = iter(values)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)
