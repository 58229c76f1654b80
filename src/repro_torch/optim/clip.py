"""Gradient clipping — the port of ``repro/optim/clip.py``, per agent:
every leaf carries a leading agent axis A and each agent's gradient is
clipped by its own global norm (the reference's under vmap)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree):
    """(A,) global norm of each agent's leaves."""
    sq = [torch.square(x.float()).reshape(x.shape[0], -1).sum(-1)
          for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum(0))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)

    def clip(x):
        s = scale.reshape(scale.shape + (1,) * (x.ndim - 1))
        return (x.float() * s).to(x.dtype)

    return tree_map(clip, tree), norm
