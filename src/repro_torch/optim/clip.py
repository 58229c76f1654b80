"""Gradient utilities — the port of ``repro/optim/clip.py``: global-norm
clipping and the non-finite guard.

Two forms of the global norm. The MARL stack (``per_agent=True``, the
default) carries a leading agent axis A on every leaf and clips each
agent's gradient by its own norm, as the reference does under vmap. An
LM tree (``per_agent=False``) has no agent axis: one norm covers the
whole tree, as the reference computes it outside vmap.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree, *, per_agent: bool = True):
    """(A,) norm of each agent's leaves, or with ``per_agent=False`` the
    0-d norm of the whole tree; squares in fp32."""
    if not per_agent:
        sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(sq)))
    sq = [torch.square(x.float()).reshape(x.shape[0], -1).sum(-1)
          for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum(0))


def clip_by_global_norm(tree, max_norm: float, *, per_agent: bool = True):
    """Scale the tree by ``min(1, max_norm / (norm + 1e-9))`` in fp32 and
    cast each leaf back to its dtype. Returns (tree, norm)."""
    norm = global_norm(tree, per_agent=per_agent)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)

    def clip(x):
        s = scale.reshape(scale.shape + (1,) * (x.ndim - scale.ndim))
        return (x.float() * s).to(x.dtype)

    return tree_map(clip, tree), norm


def sanitize(tree):
    """Zero non-finite gradient entries (lost-node blast-radius control)."""
    return tree_map(lambda x: torch.where(torch.isfinite(x.float()), x,
                                          torch.zeros_like(x)), tree)
