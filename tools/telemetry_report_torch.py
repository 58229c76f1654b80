"""Render a DIALS telemetry event log into human-readable reports — the
port of ``tools/telemetry_report.py``, over the port's event logs
(``repro_torch.obs``; the same file formats byte for byte), importing
nothing of the JAX package.

Input: a telemetry directory (per-process ``telemetry-p*.jsonl`` files,
merged on the fly if no ``telemetry.jsonl`` exists yet) or a single
JSONL file. Output:

* a per-round table: one line per round with the typed record's phase
  seconds (``repro_torch.obs.metrics.ROUND_FIELDS``), CE, staleness and
  mesh size;
* an elasticity timeline: every ``host_death`` / ``elastic_reassign``
  event, the chaos and recovery events and the rounds where the mesh size
  changed, with the availability tax ``mirror_s`` alongside;
* ``--csv FILE`` re-renders the round events through the CSV sink;
* ``--check`` validates instead of rendering: the log must be parseable
  and non-empty, every round event must pass ``metrics.validate_round``,
  and each process's round events must be monotone in the round index.
  Exit 1 on any violation.
* ``--check --expect-recovery`` also requires the recovery story in
  causal order: a ``host_death``, a generation >= 1 ``rebootstrap``
  after it, and a resumed ``run_start`` with ``start_round > 0``.

The functions, flags and printed lines are the reference's.

    PYTHONPATH=src python -m tools.telemetry_report_torch experiments/telemetry
    PYTHONPATH=src python -m tools.telemetry_report_torch run.jsonl --check
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import metrics, sinks  # noqa: E402


def load_events(path: str) -> List[Dict]:
    """Events from a telemetry dir (merging per-process files) or a
    single JSONL file, globally ordered."""
    if os.path.isdir(path):
        return sinks.read_jsonl(sinks.merge_dir(path))
    return sorted(sinks.read_jsonl(path),
                  key=lambda e: (e.get("t", 0.0), e.get("proc", 0),
                                 e.get("seq", 0)))


def _fmt(v, width=9) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.3f}".rjust(width)
    return str(v).rjust(width)


def round_table(events: List[Dict]) -> str:
    """One line per round. With several processes, the lowest-numbered
    process that emitted the round speaks for it (every process's round
    records agree on the on-mesh scalars; host timings are local)."""
    per_round: Dict[int, Dict] = {}
    for e in events:
        if e.get("event") != "round":
            continue
        rnd = e["round"]
        if rnd not in per_round or e.get("proc", 0) < \
                per_round[rnd].get("proc", 0):
            per_round[rnd] = e
    if not per_round:
        return "(no round events)"
    cols = ("round", "gs_return", "aip_ce_after", "staleness_max",
            "n_shards", "collect_s", "env_steps_per_s", "aip_s",
            "inner_s", "eval_s", "mirror_s", "round_s")
    widths = {"aip_ce_after": 13, "env_steps_per_s": 15}
    lines = [" ".join(c.rjust(widths.get(c, 9)) for c in cols)]
    for rnd in sorted(per_round):
        e = per_round[rnd]
        cells = []
        for c in cols:
            v = e.get(c)
            cells.append(_fmt(v, widths.get(c, 9)))
        lines.append(" ".join(cells))
    return "\n".join(lines)


def elasticity_timeline(events: List[Dict]) -> str:
    """The host-loss story: deaths, replans, mesh-size changes, and the
    per-round availability tax (``mirror_s``)."""
    lines = []
    prev_shards = None
    for e in events:
        kind = e.get("event")
        if kind == "host_death":
            lines.append(
                f"  round {e.get('round')}: host_death "
                f"dead={e.get('dead_hosts')} "
                f"(detected by p{e.get('proc', 0)}, "
                f"timeout {e.get('timeout_s')}s)")
        elif kind == "elastic_reassign":
            lines.append(
                f"  replan: shards {e.get('old_shards')}->"
                f"{e.get('new_shards')}, dead blocks "
                f"{e.get('dead_blocks')}, moved {e.get('moved')}")
        elif kind == "chaos_inject":
            lines.append(
                f"  round {e.get('round')}: chaos_inject "
                f"kind={e.get('kind')} host={e.get('host')} "
                f"(p{e.get('proc', 0)})")
        elif kind == "recovery_begin":
            lines.append(
                f"  round {e.get('round')}: recovery_begin "
                f"dead={e.get('dead')} -> generation "
                f"{e.get('generation')} (p{e.get('proc', 0)})")
        elif kind == "rebootstrap":
            lines.append(
                f"  rebootstrap: generation {e.get('generation')}, "
                f"{e.get('num_processes')} process(es), "
                f"{e.get('attempts')} attempt(s) (p{e.get('proc', 0)})")
        elif kind == "restore_reshard":
            lines.append(
                f"  restore: step {e.get('step')} re-sharded "
                f"{e.get('old_shards')}->{e.get('new_shards')} shards")
        elif kind == "round":
            shards = e.get("n_shards")
            if prev_shards is not None and shards != prev_shards:
                lines.append(
                    f"  round {e.get('round')}: resumed on "
                    f"{shards}-shard mesh (was {prev_shards}), "
                    f"reassigned={e.get('reassigned')}")
            prev_shards = shards
            if e.get("mirror_s") is not None:
                lines.append(
                    f"  round {e.get('round')}: mirror_s="
                    f"{e['mirror_s']:.3f}s (availability tax, "
                    f"p{e.get('proc', 0)})")
    return "\n".join(lines) if lines else "  (no elasticity events)"


def check(events: List[Dict]) -> List[str]:
    """CI validation: non-empty, schema-clean round events, per-process
    monotone round indices."""
    problems = []
    if not events:
        return ["no events"]
    rounds_by_proc: Dict[int, List[int]] = {}
    n_rounds = 0
    for i, e in enumerate(events):
        if "event" not in e:
            problems.append(f"event {i}: missing 'event' kind")
            continue
        if e["event"] != "round":
            continue
        n_rounds += 1
        for p in metrics.validate_round(e):
            problems.append(f"round event {i} (proc "
                            f"{e.get('proc')}): {p}")
        rounds_by_proc.setdefault(e.get("proc", 0), []).append(e["round"])
    if n_rounds == 0:
        problems.append("no round events")
    for proc, rounds in sorted(rounds_by_proc.items()):
        if rounds != sorted(rounds):
            problems.append(f"proc {proc}: round indices not monotone: "
                            f"{rounds}")
    return problems


def check_recovery(events: List[Dict]) -> List[str]:
    """The chaos job's gate: the log must tell the full recovery story,
    in causal order — a ``host_death`` verdict, then a ``rebootstrap``
    of generation ≥ 1 (the re-executed survivor coming back up), then a
    resumed ``run_start`` with ``start_round > 0`` (training continued
    from the committed checkpoint, not from scratch)."""
    problems = []
    death = next((i for i, e in enumerate(events)
                  if e.get("event") == "host_death"), None)
    if death is None:
        return ["expected a host_death event — no death was detected"]
    begin = next((i for i, e in enumerate(events)
                  if e.get("event") == "recovery_begin" and i > death),
                 None)
    if begin is None:
        problems.append("no recovery_begin after the host_death — the "
                        "supervisor never ran")
    reboot = next((i for i, e in enumerate(events)
                   if e.get("event") == "rebootstrap"
                   and e.get("generation", 0) >= 1 and i > death), None)
    if reboot is None:
        problems.append("no generation>=1 rebootstrap after the "
                        "host_death — the survivor never came back")
        return problems
    resumed = [e for i, e in enumerate(events)
               if e.get("event") == "run_start" and i > reboot]
    if not resumed:
        problems.append("no run_start after the rebootstrap — the "
                        "re-executed survivor never resumed training")
    elif not any(e.get("start_round", 0) > 0 for e in resumed):
        problems.append(
            "resumed run_start has start_round=0 — the survivor "
            "restarted from scratch instead of the committed checkpoint")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="telemetry directory or JSONL file")
    ap.add_argument("--csv", default=None,
                    help="also write round events as CSV to this path")
    ap.add_argument("--check", action="store_true",
                    help="validate only (schema + monotone rounds); "
                         "exit 1 on any problem")
    ap.add_argument("--expect-recovery", action="store_true",
                    help="with --check: additionally require the "
                         "host_death -> rebootstrap -> resumed "
                         "run_start recovery sequence")
    args = ap.parse_args(argv)

    events = load_events(args.path)
    if args.check:
        # violations go through the analyzer's formatter: plain
        # TAG file [rule] lines locally, ::error annotations in CI
        from repro_torch.analysis.report import Finding, emit
        problems = check(events)
        if args.expect_recovery:
            problems += check_recovery(events)
        if emit([Finding(tag="TELEMETRY-INVALID", rule="TelemetrySchema",
                         message=p, file=args.path)
                 for p in problems]):
            return 1
        procs = sorted({e.get("proc", 0) for e in events})
        n_rounds = sum(e.get("event") == "round" for e in events)
        print(f"# telemetry OK: {len(events)} events, {n_rounds} round "
              f"records, processes {procs}")
        return 0

    if args.csv:
        sink = sinks.CsvSink(args.csv)
        sinks.write_events(events, sink)
        sink.close()
        print(f"# wrote {args.csv}")

    print(f"# {args.path}: {len(events)} events from "
          f"{len({e.get('proc', 0) for e in events})} process(es)")
    start = [e for e in events if e.get("event") == "run_start"]
    if start:
        e = start[0]
        print(f"# run: path={e.get('path')} env={e.get('env')} "
              f"shards={e.get('n_shards')} kernels={e.get('kernels')}")
    print("\n== per-round phases ==")
    print(round_table(events))
    print("\n== elasticity timeline ==")
    print(elasticity_timeline(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
