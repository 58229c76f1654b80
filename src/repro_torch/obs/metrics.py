"""Round records — the pieces of ``repro/obs/metrics.py`` the loop driver
uses: the round-record schema (:data:`ROUND_FIELDS`, the same fields,
types and nullability as the reference), :func:`round_record`,
:func:`staleness_stats` and :func:`kernel_summary`."""
from __future__ import annotations

from typing import Dict, Tuple

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
