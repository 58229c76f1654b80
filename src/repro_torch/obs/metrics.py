"""Typed record schemas of the DIALS runtime's telemetry — the port of
``repro/obs/metrics.py``, with the same field names, types and
nullability: the round record both drivers emit (:data:`ROUND_FIELDS`,
:func:`round_record`, :func:`validate_round`), the envelope the JSONL
sinks wrap events in (:data:`ENVELOPE_FIELDS`), and the benchmark-row
schemas the port's benchmarks validate their rows against
(:data:`SCALING_ROW_SCHEMA`, :data:`KERNELS_MICRO_SCHEMA`,
:data:`KERNELS_E2E_SCHEMA`, :func:`validate_bench_row`).

The port's loop driver measures its phase seconds with telemetry on or
off, each phase fenced on the driver's stream by default
(``DIALSConfig.telemetry_fence``); with the async collect, ``collect_s``
is the obtain wait and ``env_steps_per_s`` is null, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.kernels import dispatch

# (name, type, nullable) — order is the canonical (CSV) column order
ROUND_FIELDS: Tuple[Tuple[str, type, bool], ...] = (
    ("round", int, False),
    ("gs_return", float, False),
    ("ials_reward", float, True),
    ("aip_ce_before", float, False),
    ("aip_ce_after", float, False),
    ("data_round", int, False),
    ("forced_sync", bool, False),
    ("stale_forced", int, False),
    ("staleness_min", int, False),
    ("staleness_mean", float, False),
    ("staleness_max", int, False),
    ("n_shards", int, False),
    ("reassigned", int, False),
    ("dead_hosts", list, False),
    ("kernels", str, False),
    ("collect_s", float, True),
    ("env_steps_per_s", float, True),
    ("aip_s", float, True),
    ("inner_s", float, True),
    ("eval_s", float, True),
    ("mirror_s", float, True),
    ("round_s", float, False),
    ("wall_s", float, False),
)

ROUND_KEYS: Tuple[str, ...] = tuple(f[0] for f in ROUND_FIELDS)
ROUND_PHASES: Tuple[str, ...] = ("collect_s", "aip_s", "inner_s",
                                 "eval_s", "mirror_s")

ENVELOPE_FIELDS: Tuple[str, ...] = ("event", "proc", "seq", "t")


def _coerce(typ: type, value):
    if typ is bool:
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is list:
        return [int(v) for v in value]
    return str(value)             # typ is str


def round_record(**fields) -> Dict:
    """A validated round record: the key set must be exactly
    :data:`ROUND_KEYS`, nulls only on nullable fields, values coerced to
    host scalars (0-d tensors accepted — the driver's one sync point)."""
    extra = set(fields) - set(ROUND_KEYS)
    if extra:
        raise TypeError(f"unknown round-record fields: {sorted(extra)}")
    missing = set(ROUND_KEYS) - set(fields)
    if missing:
        raise TypeError(f"missing round-record fields: {sorted(missing)}")
    rec = {}
    for name, typ, nullable in ROUND_FIELDS:
        value = fields[name]
        if value is None:
            if not nullable:
                raise TypeError(f"round-record field {name!r} is not "
                                f"nullable")
            rec[name] = None
        else:
            rec[name] = _coerce(typ, value)
    return rec


def validate_round(rec: Dict, *, ignore=ENVELOPE_FIELDS) -> List[str]:
    """Problems (empty list = valid) with a round record, e.g. one read
    back from a JSONL sink. Envelope fields are ignored."""
    problems = []
    got = {k for k in rec if k not in ignore}
    for k in sorted(got - set(ROUND_KEYS)):
        problems.append(f"unknown field {k!r}")
    for k in sorted(set(ROUND_KEYS) - got):
        problems.append(f"missing field {k!r}")
    for name, typ, nullable in ROUND_FIELDS:
        if name not in rec:
            continue
        value = rec[name]
        if value is None:
            if not nullable:
                problems.append(f"field {name!r} is null but not nullable")
            continue
        ok = (isinstance(value, bool) if typ is bool else
              isinstance(value, int) and not isinstance(value, bool)
              if typ is int else
              isinstance(value, (int, float)) and not isinstance(value,
                                                                 bool)
              if typ is float else
              isinstance(value, typ))
        if not ok:
            problems.append(f"field {name!r}: expected {typ.__name__}, "
                            f"got {type(value).__name__} ({value!r})")
    return problems


def staleness_stats(reports, current_round: int):
    """Per-agent data-round lag distribution (``current_round -
    reports``) as 0-d tensors."""
    lag = current_round - reports
    return {"staleness_min": lag.min(),
            "staleness_mean": lag.float().mean(),
            "staleness_max": lag.max()}


def kernel_summary(policy_cfg, aip_cfg, ppo_cfg, device) -> str:
    """Resolved kernel dispatch on ``device`` as a compact string, e.g.
    ``"policy=plain,aip=cuda,ppo=cuda"``."""
    def word(cfg):
        return "cuda" if dispatch.use_kernel(cfg.use_kernels, device) \
            else "plain"
    return ",".join(f"{n}={word(c)}" for n, c in
                    (("policy", policy_cfg), ("aip", aip_cfg),
                     ("ppo", ppo_cfg)))


# ---------------------------------------------------------------------------
# benchmark-row schemas (benchmarks/torch_scaling.py, torch_kernels.py)
# ---------------------------------------------------------------------------
# column -> (allowed types, required, nullable)
_NUM = (int, float)

SCALING_ROW_SCHEMA = {
    "name": "scaling",
    "columns": {
        "label": (str, True, False),
        "scenario": (str, True, False),
        "n_agents": (int, True, False),
        "shards": (int, True, False),
        "processes": (int, True, False),
        "streams": (int, True, False),
        "fused": (bool, True, False),
        "round_s": (_NUM, True, False),
        "round_s_async": (_NUM, True, False),
        "overlap_speedup": (_NUM, True, False),
        "inner_steps_per_s": (_NUM, True, False),
        "inner_steps_per_s_async": (_NUM, True, False),
        "total_wall_s": (_NUM, True, False),
        "total_wall_s_async": (_NUM, True, False),
        "collect_s": (_NUM, True, False),
        "env_steps_per_s": (_NUM, True, False),
        # null where the env topology cannot tile the shard count
        "collect_s_sharded_gs": (_NUM, True, True),
        "gs_speedup": (_NUM, True, True),
        # only present once the shards=1 baseline has run (P=1 cells)
        "speedup_vs_unfused": (_NUM, False, False),
    },
    "phases": ("round_s", "round_s_async", "collect_s",
               "collect_s_sharded_gs"),
}

KERNELS_MICRO_SCHEMA = {
    "name": "kernels.micro",
    "columns": {
        "kernel": (str, True, False),
        "label": (str, True, False),
        "B": (int, True, False),
        "T": (int, True, False),
        # gru rows only; gae rows have no input/hidden width
        "in": (int, False, False),
        "H": (int, False, False),
        "fwd_oracle_s": (_NUM, True, False),
        "fwd_kernel_s": (_NUM, True, False),
        "fwdbwd_oracle_s": (_NUM, True, False),
        "fwdbwd_kernel_s": (_NUM, True, False),
        "speedup_fwd": (_NUM, True, False),
        "speedup_fwdbwd": (_NUM, True, False),
        "roofline_fwd": (dict, True, False),
        "roofline_fwdbwd": (dict, True, False),
    },
    "phases": ("fwd_oracle_s", "fwd_kernel_s", "fwdbwd_oracle_s",
               "fwdbwd_kernel_s"),
}

KERNELS_E2E_SCHEMA = {
    "name": "kernels.end_to_end",
    "columns": {
        "program": (str, True, False),
        "label": (str, True, False),
        "oracle_s": (_NUM, True, False),
        "kernel_s": (_NUM, True, False),
        "speedup": (_NUM, True, False),
    },
    "phases": ("oracle_s", "kernel_s"),
}


def validate_bench_row(row: Dict, schema: Dict) -> List[str]:
    """Problems with one benchmark row against a schema above: unknown
    columns, missing required columns, non-null cells of the wrong type,
    nulls in non-nullable cells."""
    cols = schema["columns"]
    name = schema["name"]
    problems = []
    for k in sorted(set(row) - set(cols)):
        problems.append(f"[{name}] unknown column {k!r}")
    for k, (_, required, _n) in cols.items():
        if required and k not in row:
            problems.append(f"[{name}] missing column {k!r}")
    for k, value in row.items():
        if k not in cols:
            continue
        types, _required, nullable = cols[k]
        if value is None:
            if not nullable:
                problems.append(f"[{name}] column {k!r} is null")
            continue
        if types is bool or types is int:
            ok = isinstance(value, types) and (types is bool or
                                               not isinstance(value, bool))
        elif types is _NUM:
            ok = isinstance(value, _NUM) and not isinstance(value, bool)
        else:
            ok = isinstance(value, types)
        if not ok:
            tn = types.__name__ if isinstance(types, type) else "number"
            problems.append(f"[{name}] column {k!r}: expected {tn}, got "
                            f"{type(value).__name__} ({value!r})")
    return problems


def phase_breakdown(row: Dict, schema: Dict) -> str:
    """Compact ``col=value`` summary of a bench row's phase columns."""
    parts = []
    for col in schema.get("phases", ()):
        v = row.get(col)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            parts.append(f"{col}={v:.6g}")
        else:
            parts.append(f"{col}={v}")
    return " ".join(parts)
