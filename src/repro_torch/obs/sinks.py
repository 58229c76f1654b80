"""Telemetry sinks — per-process JSONL event logs and their merge; the
port's own copy of ``repro/obs/sinks.py`` (plain Python, the same file
formats byte for byte).

Every process appends to its own ``telemetry-p{PID}.jsonl`` in a shared
directory (one JSON object per line, flushed per line, so a killed
process's events survive up to a possibly truncated last line), and rank
0 merges all per-process files into one ``telemetry.jsonl`` ordered by
``(t, proc, seq)``. Writing needs no coordination between processes.

Also here: a terminal sink (one line per event for interactive runs) and
a CSV sink (round events only, columns in ``metrics.ROUND_FIELDS``
order).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import metrics

MERGED_NAME = "telemetry.jsonl"


def proc_path(directory: str, process_id: int) -> str:
    """Per-process event-log path inside the shared telemetry dir."""
    return os.path.join(directory, f"telemetry-p{process_id}.jsonl")


def read_jsonl(path: str) -> List[Dict]:
    """Parse a JSONL event file, tolerating a truncated final line (a
    process killed mid-write): the complete lines before it are kept."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                break             # truncated tail; nothing valid follows
    return events


def merge_dir(directory: str, *, out: Optional[str] = None) -> str:
    """Merge every ``telemetry-p*.jsonl`` in ``directory`` into one
    globally ordered file (sort key ``(t, proc, seq)``) and return its
    path. Re-merging is idempotent."""
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("telemetry-p") and
                   n.endswith(".jsonl"))
    events: List[Dict] = []
    for name in names:
        events.extend(read_jsonl(os.path.join(directory, name)))
    events.sort(key=lambda e: (e.get("t", 0.0), e.get("proc", 0),
                               e.get("seq", 0)))
    out = out or os.path.join(directory, MERGED_NAME)
    with open(out, "w") as f:
        for e in events:
            f.write(json.dumps(e, default=float) + "\n")
    return out


class JsonlSink:
    """Append-only per-process JSONL writer, flushed per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def write(self, event: Dict) -> None:
        self._f.write(json.dumps(event, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TerminalSink:
    """One compact line per event on stdout: the interactive view of the
    stream the JSONL sink keeps."""

    def __init__(self, prefix: str = "telemetry"):
        self.prefix = prefix

    def write(self, event: Dict) -> None:
        kind = event.get("event", "?")
        if kind == "round":
            phases = " ".join(
                f"{p}={event[p]:.3f}s" for p in metrics.ROUND_PHASES
                if isinstance(event.get(p), (int, float)))
            line = (f"round {event.get('round')} "
                    f"return={event.get('gs_return'):.3f} "
                    f"ce={event.get('aip_ce_after'):.4f} "
                    f"lag<={event.get('staleness_max')} "
                    f"shards={event.get('n_shards')} "
                    f"round_s={event.get('round_s'):.3f}"
                    + (f" {phases}" if phases else ""))
        elif kind == "host_death":
            line = (f"host death at round {event.get('round')}: "
                    f"dead={event.get('dead_hosts')}")
        elif kind == "elastic_reassign":
            line = (f"elastic replan: shards "
                    f"{event.get('old_shards')}->{event.get('new_shards')}"
                    f" moved={event.get('moved')}")
        else:
            payload = {k: v for k, v in event.items()
                       if k not in metrics.ENVELOPE_FIELDS}
            line = f"{kind} {payload}"
        print(f"[{self.prefix} p{event.get('proc', 0)}] {line}")

    def close(self) -> None:
        pass


class CsvSink:
    """Round events as CSV, columns in ``metrics.ROUND_FIELDS`` order
    (``dead_hosts`` written as ``;``-joined host indices). Other events
    are skipped."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(("proc",) + metrics.ROUND_KEYS)

    def write(self, event: Dict) -> None:
        if event.get("event") != "round":
            return
        row = [event.get("proc", 0)]
        for name in metrics.ROUND_KEYS:
            v = event.get(name)
            row.append(";".join(str(h) for h in v)
                       if isinstance(v, list) else v)
        self._w.writerow(row)
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def write_events(events: Iterable[Dict], sink) -> None:
    """Replay an event stream (e.g. a merged file) through a sink."""
    for e in events:
        sink.write(e)
