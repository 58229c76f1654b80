"""DIALS-outer optimizer — the port of ``repro/optim/outer.py``: the
paper's pattern at the pod level.

Each pod is a "local region": it runs ``F`` inner AdamW steps with no
cross-pod collective; every ``F`` steps the pods exchange the parameter
delta (optionally int8-compressed with error feedback) and apply a
Nesterov outer step (DiLoCo-style). ``F`` plays the role of the AIP
refresh period of Algorithm 1.

One pod only: ``pod_axis`` set raises, since the cross-pod collective
needs the LM mesh (ROADMAP queue 1 item 12d). With one pod the mean over
pods is the pod's own delta, and the compression and the outer update
run as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.optim import compress as comp
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    outer_lr: float = 0.7
    momentum: float = 0.9
    nesterov: bool = True
    sync_every: int = 50             # F, in inner steps
    compress_int8: bool = True       # shrink the only cross-pod collective 4x


def init(params):
    return {
        "anchor": tree_map(lambda p: p.detach().float().clone(), params),
        "velocity": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params),
    }


def outer_step(local_params, state, cfg: OuterConfig, *,
               pod_axis: Optional[str] = None, err_tree=None):
    """Reconcile after F inner steps: delta = anchor - local (int8 round
    trip with error feedback if configured), Nesterov outer update on the
    anchor, and the pod restarts from the new anchor. Returns
    (new_params, new_state, new_err_tree)."""
    if pod_axis is not None:
        raise NotImplementedError(
            "the cross-pod delta exchange needs the LM mesh (ROADMAP queue "
            "1 item 12d); one pod runs with pod_axis=None")
    anchor, vel = state["anchor"], state["velocity"]
    delta = tree_map(lambda a, p: a - p.float(), anchor, local_params)

    if cfg.compress_int8:
        if err_tree is None:
            err_tree = comp.init_error(delta)
        q, s, err_tree = comp.tree_compress(delta, err_tree)
        delta = comp.tree_decompress(q, s, delta)

    new_vel = tree_map(lambda v, d: cfg.momentum * v + d, vel, delta)
    if cfg.nesterov:
        step_dir = tree_map(lambda v, d: cfg.momentum * v + d, new_vel, delta)
    else:
        step_dir = new_vel
    new_anchor = tree_map(lambda a, s_: a - cfg.outer_lr * s_, anchor,
                          step_dir)
    new_params = tree_map(lambda a, p: a.to(p.dtype), new_anchor,
                          local_params)
    return new_params, {"anchor": new_anchor, "velocity": new_vel}, err_tree
