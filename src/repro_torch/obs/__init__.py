"""Runtime observability for the DIALS runtime — the port of
``repro/obs/__init__.py``.

``Telemetry`` is the facade the driver talks to: it owns a span
:class:`~repro_torch.obs.trace.Tracer`, a per-process JSONL sink
(``telemetry-p{PID}.jsonl`` in a shared directory) and any extra sinks
(terminal summary, CSV). Every emitted event gets an envelope, ``event``
kind, ``proc``, per-process monotone ``seq`` and unix ``t``, so rank 0
can merge all processes' files into one globally ordered
``telemetry.jsonl`` (:func:`repro_torch.obs.sinks.merge_dir`). The
process id is the ``torch.distributed`` rank when a process group is
initialised, else 0.

The disabled instance is :data:`DISABLED` (what :func:`maybe` returns for
a ``None`` directory): ``emit`` is a no-op, ``span`` is the shared null
span, and no file is created.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from repro_torch.obs import metrics, sinks
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   annotate, profile)

__all__ = ["Telemetry", "DISABLED", "maybe", "Tracer", "NullTracer",
           "NULL_TRACER", "annotate", "profile", "metrics", "sinks"]


def _default_process_id() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Telemetry:
    """Live telemetry: span tracer + per-process event sinks."""

    enabled = True

    def __init__(self, directory: str, *, process_id: int,
                 tracer: Tracer, extra_sinks=()):
        self.directory = directory
        self.process_id = process_id
        self.tracer = tracer
        self._seq = 0
        self._sinks: List = [sinks.JsonlSink(
            sinks.proc_path(directory, process_id))]
        self._sinks.extend(extra_sinks)

    @classmethod
    def create(cls, directory: str, *, process_id: Optional[int] = None,
               terminal: bool = False, csv: Optional[str] = None,
               fence: bool = False) -> "Telemetry":
        os.makedirs(directory, exist_ok=True)
        extra = []
        if terminal:
            extra.append(sinks.TerminalSink())
        if csv:
            extra.append(sinks.CsvSink(csv))
        pid = process_id if process_id is not None \
            else _default_process_id()
        return cls(directory, process_id=pid, tracer=Tracer(fenced=fence),
                   extra_sinks=extra)

    def emit(self, event: str, **fields) -> Dict:
        """Wrap ``fields`` in the envelope and write to every sink."""
        rec = {"event": event, "proc": self.process_id, "seq": self._seq,
               "t": time.time(), **fields}
        self._seq += 1
        for s in self._sinks:
            s.write(rec)
        return rec

    def emit_round(self, rec: Dict) -> Dict:
        """Emit a (:func:`metrics.round_record`-typed) round record as a
        ``"round"`` event."""
        return self.emit("round", **rec)

    def span(self, name: str):
        return self.tracer.span(name)

    def phase_seconds(self) -> Dict[str, float]:
        return self.tracer.phase_seconds()

    def reset_spans(self) -> None:
        self.tracer.reset()

    def merge(self) -> str:
        """Merge every process's event file in this directory (call on
        rank 0, after the run)."""
        return sinks.merge_dir(self.directory)

    def close(self) -> None:
        for s in self._sinks:
            s.close()


class _NullTelemetry:
    """Disabled telemetry: no files, no state, no-op everything."""

    enabled = False
    directory = None
    process_id = 0
    tracer = NULL_TRACER

    def emit(self, event: str, **fields) -> None:
        return None

    def emit_round(self, rec: Dict) -> None:
        return None

    def span(self, name: str):
        return NULL_TRACER.span(name)

    def phase_seconds(self) -> Dict[str, float]:
        return {}

    def reset_spans(self) -> None:
        pass

    def merge(self) -> None:
        return None

    def close(self) -> None:
        pass


DISABLED = _NullTelemetry()


def maybe(directory: Optional[str], **kwargs):
    """``Telemetry.create(directory, ...)`` when ``directory`` is set,
    :data:`DISABLED` otherwise."""
    if not directory:
        return DISABLED
    return Telemetry.create(directory, **kwargs)
