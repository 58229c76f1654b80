"""AdamW with fp32 master weights — the port of ``repro/optim/adamw.py``.

State layout ``{"mu", "nu", "master", "step"}`` mirrors the reference's,
with the leading agent axis A of the per-agent stacks the MARL stack
trains (``step`` is (A,)). Decay applies to leaves whose PER-AGENT rank
is at least ``decay_min_ndim``, as under the reference's vmap.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # param labels with per-agent ndim <= 1 (biases, scalars) skip decay
    decay_min_ndim: int = 2


def init(params):
    """Optimizer state for per-agent params (leaves (A, ...))."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    first = leaves(params)[0]
    return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "step": torch.zeros(first.shape[:1], dtype=torch.int64,
                                device=first.device)}


def update(grads, state, lr, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_master_tree, new_state); moment math in fp32."""
    step = state["step"] + 1
    t = step.float()

    def per_agent(x, ndim):
        return x.reshape(x.shape + (1,) * (ndim - 1))

    out = []
    for g, mu, nu, m in zip(leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"]), leaves(state["master"])):
        c1 = per_agent(1.0 - cfg.b1 ** t, m.ndim)
        c2 = per_agent(1.0 - cfg.b2 ** t, m.ndim)
        g = g.float()
        mu = cfg.b1 * mu + (1.0 - cfg.b1) * g
        nu = cfg.b2 * nu + (1.0 - cfg.b2) * torch.square(g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if m.ndim - 1 >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * m
        out.append((mu, nu, m - lr * delta))
    new = [unflatten_like(state["mu"], [o[i] for o in out]) for i in range(3)]
    return new[2], {"mu": new[0], "nu": new[1], "master": new[2],
                    "step": step}


def cast_like(master, params):
    """Cast fp32 master back to the params' dtypes."""
    return tree_map(lambda m, p: m.to(p.dtype), master, params)
