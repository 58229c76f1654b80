"""Mesh definitions — the port of ``repro/launch/mesh.py`` (functions:
importing this module touches no process group).

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks. The ``pod`` axis carries ONLY the DIALS-outer
reconciliation collective (every F steps) and the batch split; the inner
train step has no per-step cross-pod collective by construction.

Each is a named ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the process's default group, which must have exactly as many
ranks: the dry-run's fake group of 256 or 512 (``launch.dryrun``), or a
live gloo group (:func:`make_group_mesh`). :func:`make_host_mesh` is the
(data=1, model=1) mesh of one process, through the same DTensor code.
"""
from __future__ import annotations

from typing import Sequence


def make_group_mesh(shape: Sequence[int], names: Sequence[str], *,
                    device_type: str = "cuda"):
    """A named mesh over every rank of the live default group (row-major
    rank order), on ``device_type`` tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_group_mesh(shape, axes, device_type=device_type)


def make_host_mesh(*, device_type: str = "cuda"):
    """A (data=1, model=1) mesh of this process alone (same axis names,
    size 1). Without a group, it starts a one-rank gloo group of its own
    (``bootstrap.solo_group``, which a later ``bootstrap()`` replaces);
    in a group of several ranks, a one-rank subgroup of this rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import bootstrap
    group = bootstrap.solo_group()
    rank = dist.get_rank()
    return DeviceMesh.from_group(
        [group, group], device_type,
        mesh=torch.tensor([[rank]], dtype=torch.int64),
        mesh_dim_names=("data", "model"))
