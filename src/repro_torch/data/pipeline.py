"""Batch feeding — the port of ``repro/data/pipeline.py``.

The iterator is deterministic in (seed, step), so a restart resumes
mid-stream without reading earlier data (a checkpoint stores only the
step). Batches are drawn on ``device``: ``"cuda"`` unless the caller asks
for the CPU; with a ``mesh`` (``launch.mesh``) each batch is laid out over
its batch axes (:func:`shard_batch`).
"""
from __future__ import annotations

from typing import Callable, Iterator

from repro_torch import random as R
from repro_torch.data import synthetic
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.kernels import dispatch
from repro_torch.tree import tree_map


def shard_batch(batch, mesh, *, long_context: bool = False):
    """Every leaf (the same full tensor on each rank) as a DTensor split
    along its leading axis over the mesh's batch axes (pod, data), the
    rest whole; ``long_context`` replicates it."""
    sh = mesh_lib.batch_sharding(mesh, long_context=long_context)
    return tree_map(lambda x: mesh_lib.distribute(x, sh), batch)


def lm_iterator(seed: int, batch: int, seq: int, vocab: int, mesh=None, *,
                start_step: int = 0, device="cuda") -> Iterator[dict]:
    """Batch ``step`` from ``fold_in(key(seed), step)``: restart-safe."""
    device = dispatch.resolve_device(device)
    root = R.key(seed, device=device)
    step = start_step
    while True:
        b = synthetic.lm_batch(R.fold_in(root, step), batch, seq, vocab)
        if mesh is not None:
            b = shard_batch(b, mesh)
        yield b
        step += 1


def with_extras(it: Iterator[dict], extra_fn: Callable[[int], dict],
                start_step: int = 0) -> Iterator[dict]:
    """Attach modality extras (frames/patches) to each LM batch."""
    step = start_step
    for b in it:
        yield {**b, **extra_fn(step)}
        step += 1
