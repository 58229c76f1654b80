"""Nested dict/list/tuple containers of tensors — the port's stand-in for
``jax.tree``. Containers are rebuilt, leaves are passed to ``fn``."""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten_like(tree, flat: list):
    """Rebuild ``tree``'s structure from leaves in :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def take_rows(tree, idx):
    """Per-agent gather along axis 1: leaves (A, E, ...), idx (A, b) ->
    leaves (A, b, ...)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda x: x[rows, idx], tree)
