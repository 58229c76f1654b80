"""Steady-state recompile detector — the port of
``repro/analysis/recompile.py``.

The reference counts XLA compilations from jax's compile log. The port
compiles two things at run time: the CUDA kernel module, built and loaded
at first use (``repro_torch.kernels.build.build_count``), and
``torch.compile`` frames (dynamo's ``frames/ok`` counter), of which the
loop driver has none today. :class:`CompileCounter` counts both while it
is active, and :func:`check_steady_state` (the reference's semantics)
turns per-round snapshots of the count, taken from the driver's per-round
``log`` callback, into findings: after round 0, no round may compile.

What it does not see: ``build.extension()`` caches the module, so a
build ticks at most once per process, and a run whose module an earlier
call built shows no build at all; nor does it count what eager PyTorch
compiles on its own per shape (NVRTC jiterator kernels, lazily loaded
CUDA modules).
"""
from __future__ import annotations

import sys
from typing import List, Sequence

from repro_torch.analysis.report import Finding
from repro_torch.kernels import build

__all__ = ["CompileCounter", "check_steady_state"]


def _dynamo_frames() -> int:
    """Frames dynamo has compiled in this process (0 when it was never
    imported: nothing went through ``torch.compile``)."""
    dynamo_utils = sys.modules.get("torch._dynamo.utils")
    if dynamo_utils is None:
        return 0
    return int(dynamo_utils.counters["frames"]["ok"])


class CompileCounter:
    """Context manager counting kernel-module builds and ``torch.compile``
    frames while active.

    ::

        with CompileCounter() as cc:
            counts = []
            trainer.run(key, log=lambda rec: counts.append(cc.count))
        problems = check_steady_state(counts, what="loop driver")
    """

    def __init__(self):
        self._start = (0, 0)

    @property
    def builds(self) -> int:
        return build.build_count() - self._start[0]

    @property
    def frames(self) -> int:
        return _dynamo_frames() - self._start[1]

    @property
    def count(self) -> int:
        return self.builds + self.frames

    @property
    def names(self) -> List[str]:
        return (["kernel module build"] * self.builds
                + ["torch.compile frame"] * self.frames)

    def __enter__(self) -> "CompileCounter":
        self._start = (build.build_count(), _dynamo_frames())
        return self

    def __exit__(self, *exc):
        return False


def check_steady_state(per_round_counts: Sequence[int], *,
                       what: str = "driver") -> List[Finding]:
    """Findings for any round after the first that compiled.

    ``per_round_counts[i]`` is the cumulative compile count observed
    when round ``i``'s record arrived. Round 0 may compile anything it
    likes (it IS the compile round); every later round must hold the
    counter flat. Needs at least two rounds to say anything.
    """
    out: List[Finding] = []
    if len(per_round_counts) < 2:
        return out
    steady = per_round_counts[0]
    for i, count in enumerate(per_round_counts[1:], start=1):
        if count > steady:
            out.append(Finding(
                tag="CONTRACT-VIOLATION", rule="SteadyStateCompile",
                message=f"{what}: round {i} triggered "
                        f"{count - steady} recompilation(s) after the "
                        f"warm-up round — a static argument or shape "
                        f"is changing per round"))
            steady = count
    return out
