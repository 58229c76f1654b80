"""DIALS-outer optimizer — the port of ``repro/optim/outer.py``: the
paper's pattern at the pod level.

Each pod is a "local region": it runs ``F`` inner AdamW steps with no
cross-pod collective; every ``F`` steps the pods exchange the parameter
delta (optionally int8-compressed with error feedback) and apply a
Nesterov outer step (DiLoCo-style). ``F`` plays the role of the AIP
refresh period of Algorithm 1.

With ``pod_axis`` (a mesh axis name) and the ``mesh`` that has it, the
pods reconcile across that axis: each rank holds its pod's block of
every leaf (a plain tensor, or a DTensor's local block), and the ranks at
the same place in every pod exchange their deltas — fp32: an all-reduce
mean over the pod group; int8: an all-gather of the int8 deltas and
their fp32 row scales (int8 stays int8 on the wire, as in the
reference), dequantized and averaged locally. A DTensor leaf's int8 row
scales are its local block's. Without ``pod_axis`` there is one pod: the
mean over pods is the pod's own delta.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.mesh import is_dtensor
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


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _pod_mean(d, group, n: int):
    out = d.clone()
    dist.all_reduce(out, group=group)
    return out / n


def _pod_gather_mean(q, s, d, group, n: int):
    qg = [torch.empty_like(q) for _ in range(n)]
    sg = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qg, q.contiguous(), group=group)
    dist.all_gather(sg, s.contiguous(), group=group)
    deq = torch.stack([comp.decompress(qq, ss, d.shape)
                       for qq, ss in zip(qg, sg)])
    return deq.mean(0)


def outer_step(local_params, state, cfg: OuterConfig, *,
               pod_axis: Optional[str] = None, err_tree=None, mesh=None):
    """Reconcile after F inner steps: delta = anchor - local (int8 round
    trip with error feedback if configured), the pod mean of the deltas
    over ``pod_axis`` of ``mesh`` (the only cross-pod collective), the
    Nesterov outer update on the anchor, and every pod restarts from the
    new anchor. Returns (new_params, new_state, new_err_tree), leaves as
    the inputs' (DTensor leaves keep their layout)."""
    anchor, vel = state["anchor"], state["velocity"]
    wrap = local_params
    local_params = tree_map(_local, local_params)
    anchor, vel = tree_map(_local, anchor), tree_map(_local, vel)
    delta = tree_map(lambda a, p: a - p.float(), anchor, local_params)
    group = n_pods = None
    if pod_axis is not None:
        group = mesh.get_group(pod_axis)
        n_pods = mesh.size(list(mesh.mesh_dim_names).index(pod_axis))

    if cfg.compress_int8:
        if err_tree is None:
            err_tree = comp.init_error(delta)
        q, s, err_tree = comp.tree_compress(delta, tree_map(_local,
                                                            err_tree))
        if pod_axis is not None:
            delta = tree_map(lambda qq, ss, d: _pod_gather_mean(
                qq, ss, d, group, n_pods), q, s, delta)
        else:
            delta = comp.tree_decompress(q, s, delta)
    elif pod_axis is not None:
        delta = tree_map(lambda d: _pod_mean(d, group, n_pods), delta)

    new_vel = tree_map(lambda v, d: cfg.momentum * v + d, vel, delta)
    if cfg.nesterov:
        step_dir = tree_map(lambda v, d: cfg.momentum * v + d, new_vel, delta)
    else:
        step_dir = new_vel
    new_anchor = tree_map(lambda a, s_: a - cfg.outer_lr * s_, anchor,
                          step_dir)
    new_params = tree_map(lambda a, p: a.to(p.dtype), new_anchor,
                          local_params)
    like = state["anchor"]
    return (tree_map(_rewrap, new_params, wrap),
            {"anchor": tree_map(_rewrap, new_anchor, like),
             "velocity": tree_map(_rewrap, new_vel, like)}, err_tree)


def _rewrap(x, like):
    """``x`` (a local block) laid out as ``like`` if it is a DTensor."""
    if not is_dtensor(like):
        return x
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())
