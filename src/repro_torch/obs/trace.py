"""Lightweight span tracer for the DIALS runtime — the port of
``repro/obs/trace.py``.

Three layers of the same idea, "name the time":

* **Host spans** (:class:`Tracer.span`): nested context-manager spans on
  a monotonic clock (``time.perf_counter``). Each span records
  ``(name, depth, t0, dur_s)``; :meth:`Tracer.phase_seconds` aggregates
  them into the per-phase seconds of the round record
  (``repro_torch.obs.metrics``). CUDA launches return before the device
  has run them, so an unfenced span measures the host's enqueue time; a
  fenced tracer's ``sp.fence(outputs)`` waits, before the clock stops,
  for the work queued so far on the caller's CURRENT stream: one CUDA
  event recorded there and synchronised. It never waits for the whole
  device (``torch.cuda.synchronize``), so work on other streams, such as
  the overlapped GS collect (``repro_torch.distributed.async_collect``),
  runs on past a fence.
* **Annotations** (:func:`annotate`): ``torch.profiler.record_function``,
  so a region is named on a profiler timeline; host spans enter one too.
  The names open on a thread (:func:`open_labels`) are the labels the
  op walker (``repro_torch.analysis.walker``) stamps on every op, as
  ``named_scope`` labels are in the reference.
* **Profiler sessions** (:func:`profile`): an opt-in ``torch.profiler``
  window that exports a Chrome trace into a directory.

The disabled path is :data:`NULL_TRACER`: its :meth:`~NullTracer.span`
returns one shared no-op span, so leaving tracer calls in place costs
nothing when telemetry is off.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.tree import leaves


_open = threading.local()


def open_labels() -> Tuple[str, ...]:
    """The spans and annotations open on this thread, outermost first."""
    return tuple(getattr(_open, "labels", ()))


@contextlib.contextmanager
def annotate(name: str):
    """A named region on the profiler's timeline
    (``torch.profiler.record_function``), open in :func:`open_labels`
    while it runs."""
    labels = getattr(_open, "labels", None)
    if labels is None:
        labels = _open.labels = []
    labels.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        labels.pop()


@contextlib.contextmanager
def profile(directory: Optional[str]):
    """Opt-in ``torch.profiler`` session (host ops, and CUDA kernels when
    a card is visible) exporting ``trace.json`` (Chrome trace format)
    into ``directory``. ``None`` is a no-op, so call sites can thread a
    ``--profile-dir`` flag through unconditionally."""
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def _cuda_device(value):
    """The device of the first CUDA tensor among ``value``'s leaves, else
    None."""
    for x in leaves(value):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


class Span:
    """One live span. ``fence(x)`` optionally waits for the device work
    queued on the current stream so the span covers its execution, then
    returns ``x``."""

    __slots__ = ("_tracer", "name", "depth", "t0")

    def __init__(self, tracer: "Tracer", name: str, depth: int, t0: float):
        self._tracer, self.name, self.depth, self.t0 = \
            tracer, name, depth, t0

    def fence(self, value):
        if self._tracer.fenced:
            device = _cuda_device(value)
            if device is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                done.synchronize()
        return value


class Tracer:
    """Records nested host spans; see the module docstring."""

    def __init__(self, *, fenced: bool = False, clock=time.perf_counter):
        self.fenced = bool(fenced)
        self._clock = clock
        self._depth = 0
        self.events: List[Dict] = []

    @property
    def enabled(self) -> bool:
        return True

    @contextlib.contextmanager
    def span(self, name: str):
        depth, self._depth = self._depth, self._depth + 1
        with annotate(name):
            t0 = self._clock()
            sp = Span(self, name, depth, t0)
            try:
                yield sp
            finally:
                dur = self._clock() - t0
                self._depth = depth
                # appended at exit: children land before their parent;
                # readers re-nest via (t0, depth)
                self.events.append({"name": name, "depth": depth,
                                    "t0": t0, "dur_s": dur})

    def reset(self) -> None:
        self.events.clear()

    def phase_seconds(self) -> Dict[str, float]:
        """Total seconds per span name (occurrences of a name sum; a name
        nested under itself would count twice, which the runtime never
        does)."""
        out: Dict[str, float] = {}
        for e in self.events:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur_s"]
        return out


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def fence(value):
        return value


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: one shared no-op span, no state, no recording."""

    fenced = False
    events: List[Dict] = []       # shared and always empty

    @property
    def enabled(self) -> bool:
        return False

    def span(self, name: str):
        return _NULL_SPAN

    def reset(self) -> None:
        pass

    def phase_seconds(self) -> Dict[str, float]:
        return {}


NULL_TRACER = NullTracer()
