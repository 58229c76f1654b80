"""Bounded staleness — the two pieces of ``repro/distributed/fault.py`` the
loop driver uses: ``masked_tree_update`` and ``freshness_gate``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def masked_tree_update(old_tree, new_tree, fresh_mask):
    """Per-agent update: agents with ``fresh_mask`` (N,) = 1 take the new
    leaf, stale agents keep the old one. Leaves have leading axis N."""
    def sel(old, new):
        m = fresh_mask.reshape((-1,) + (1,) * (old.ndim - 1)).to(old.dtype)
        return old * (1 - m) + new * m
    return tree_map(sel, old_tree, new_tree)


def heartbeat_mask(report_steps, current_step: int, max_staleness: int):
    """(N,) last-report step per agent -> {0,1} fresh mask."""
    return (current_step - report_steps <= max_staleness).float()


def freshness_gate(fresh_mask, report_rounds, data_round: int,
                   current_round: int, max_staleness: int):
    """The bounded-staleness contract (Lemma 2 / Theorem 1).

    ``fresh_mask`` (N,) says whose AIP update arrived in time this round;
    ``report_rounds`` (N,) is the collection round of the newest dataset
    each agent's predictor was trained on. An agent whose last report
    would fall further behind than ``max_staleness`` is force-refreshed.
    Returns ``(effective_mask, new_report_rounds, forced)``."""
    within = heartbeat_mask(report_rounds, current_round, max_staleness)
    fresh_mask = fresh_mask.float()
    # forced = would have straggled AND already past the bound
    forced = (1.0 - within) * (1.0 - fresh_mask)
    effective = torch.maximum(fresh_mask, forced)
    new_reports = torch.where(effective > 0,
                              torch.full_like(report_rounds, data_round),
                              report_rounds)
    return effective, new_reports, forced
