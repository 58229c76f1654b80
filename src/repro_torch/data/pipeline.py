"""Batch feeding — the port of ``repro/data/pipeline.py`` for one device.

The iterator is deterministic in (seed, step), so a restart resumes
mid-stream without reading earlier data (a checkpoint stores only the
step). Batches are drawn on ``device``: ``"cuda"`` unless the caller asks
for the CPU. ``shard_batch`` (placing a batch on the LM mesh) waits for
ROADMAP queue 1 item 12d.
"""
from __future__ import annotations

from typing import Callable, Iterator

from repro_torch import random as R
from repro_torch.data import synthetic
from repro_torch.kernels import dispatch


def shard_batch(batch, mesh, *, long_context: bool = False):
    raise NotImplementedError(
        "placing a batch on the LM mesh is not ported (ROADMAP queue 1 "
        "item 12d)")


def lm_iterator(seed: int, batch: int, seq: int, vocab: int, *,
                start_step: int = 0, device="cuda") -> Iterator[dict]:
    """Batch ``step`` from ``fold_in(key(seed), step)``: restart-safe."""
    device = dispatch.resolve_device(device)
    root = R.key(seed, device=device)
    step = start_step
    while True:
        yield synthetic.lm_batch(R.fold_in(root, step), batch, seq, vocab)
        step += 1


def with_extras(it: Iterator[dict], extra_fn: Callable[[int], dict],
                start_step: int = 0) -> Iterator[dict]:
    """Attach modality extras (frames/patches) to each LM batch."""
    step = start_step
    for b in it:
        yield {**b, **extra_fn(step)}
        step += 1
