"""Fault tolerance: straggler mitigation, bounded-staleness updates and
elastic shard reassignment — the port of ``repro/distributed/fault.py``.

Between AIP refreshes the per-region simulators are independent, so a
slow or dead shard only delays its own region's data; the paper's
staleness tolerance (Lemma 2 / Theorem 1) is the license to keep training
everyone else on slightly stale influence.

* :func:`straggler_plan` — deterministic work reassignment for late
  shards.
* :func:`masked_tree_update` / :func:`freshness_gate` — the
  bounded-staleness update the AIP round applies.
* :func:`elastic_plan` / :class:`ElasticPlan` — the host-loss extension
  of the straggler plan: a dead host's agent blocks go to the surviving
  shards on a shrunken mesh and training continues.
* :func:`reshard_agents` — the tensor half of a plan: an agent-stacked
  tree placed onto the shrunken :class:`~repro_torch.distributed.runtime.
  ShardMesh`.
* :class:`HostMonitor` — the heartbeat: a beat file per host per round
  in a shared directory (the reference's file names, so a JAX monitor and
  a port monitor see each other's beats), with a timeout-gated wait that
  turns a silent host into a ``dead`` verdict every survivor agrees on.

The reference's ``reshard`` (a pytree onto an LM mesh under its logical
rules) needs the LM mesh rules (``distributed/mesh.py``), which belong to
the LM stack (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Sequence, Set, Tuple

import torch

from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StragglerPlan:
    """Deterministic reassignment: every late shard's work unit is re-run
    by the healthy shard that (cyclically) follows it, chosen by shard id
    so all hosts compute the same plan with no coordination."""
    reassign: Dict[int, int]          # late shard -> healthy shard
    healthy: Tuple[int, ...]

    def owner(self, work_unit: int) -> int:
        return self.reassign.get(work_unit, work_unit)


def straggler_plan(n_shards: int, late: Sequence[int]) -> StragglerPlan:
    late_set = set(late)
    healthy = tuple(i for i in range(n_shards) if i not in late_set)
    if not healthy:
        raise RuntimeError("all shards late — cannot build a plan")
    reassign = {}
    for j, shard in enumerate(sorted(late_set)):
        reassign[shard] = healthy[(shard + j) % len(healthy)]
    return StragglerPlan(reassign=reassign, healthy=healthy)


# ---------------------------------------------------------------------------
# bounded staleness
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# elastic shard reassignment (host loss)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Where every agent block lands after dead shards are removed: the
    mesh shrinks from ``old_shards`` to ``new_shards`` and the agent axis
    is re-tiled evenly over the survivors (ownership after the move is
    the new even tiling; the plan records it so drivers and tests can
    assert the partition without touching a device)."""
    n_agents: int
    old_shards: int
    new_shards: int
    dead: Tuple[int, ...]            # dead shard ids in the OLD mesh
    survivors: Tuple[int, ...]       # surviving old shard ids, in order

    def __post_init__(self):
        if self.n_agents % self.old_shards or self.n_agents % self.new_shards:
            raise ValueError(
                f"{self.n_agents} agents must tile both the old "
                f"({self.old_shards}) and new ({self.new_shards}) meshes")

    def agent_owner(self, agent: int) -> int:
        """New shard id owning ``agent`` after the move (even tiling)."""
        if not 0 <= agent < self.n_agents:
            raise ValueError(f"agent {agent} outside [0, {self.n_agents})")
        return agent // (self.n_agents // self.new_shards)

    def owner(self, block: int) -> int:
        """New shard id owning OLD shard ``block``'s first agent (the
        work-unit view, mirroring :meth:`StragglerPlan.owner`)."""
        if not 0 <= block < self.old_shards:
            raise ValueError(f"block {block} outside [0, {self.old_shards})")
        return self.agent_owner(block * (self.n_agents // self.old_shards))

    @property
    def reassigned_blocks(self) -> Tuple[int, ...]:
        return self.dead


def elastic_plan(n_agents: int, n_shards: int, dead: Sequence[int],
                 *, telemetry=None) -> ElasticPlan:
    """Plan the shrink after ``dead`` shards (hosts' shard slots) vanish.

    The new shard count is the largest divisor of ``n_agents`` that fits
    the surviving slots (``runtime.choose_shards``), so agents always
    tile exactly. With ``telemetry`` set (a ``repro_torch.obs.
    Telemetry``), the plan is emitted as an ``elastic_reassign`` event
    (dead blocks, the shrink, the block -> new-owner mapping)."""
    from repro_torch.distributed import runtime
    dead_set = set(dead)
    if not dead_set <= set(range(n_shards)):
        raise ValueError(f"dead shards {sorted(dead_set)} outside "
                         f"[0, {n_shards})")
    survivors = tuple(i for i in range(n_shards) if i not in dead_set)
    if not survivors:
        raise RuntimeError("all shards dead — nothing to reassign to")
    new_shards = runtime.choose_shards(n_agents, len(survivors))
    plan = ElasticPlan(n_agents=n_agents, old_shards=n_shards,
                       new_shards=new_shards, dead=tuple(sorted(dead_set)),
                       survivors=survivors)
    if telemetry is not None:
        telemetry.emit(
            "elastic_reassign", n_agents=n_agents,
            old_shards=plan.old_shards, new_shards=plan.new_shards,
            dead_blocks=list(plan.dead), survivors=list(plan.survivors),
            # str keys: JSON objects cannot carry int keys
            moved={str(b): plan.owner(b) for b in plan.dead})
    return plan


def reshard_agents(tree, new_mesh):
    """Place an agent-stacked tree (every tensor leaf has leading axis N,
    the full tree every survivor holds, e.g. the driver's host mirror)
    onto the shrunken mesh: this shard's block of it."""
    from repro_torch.distributed import runtime
    return runtime.shard_agent_tree(tree, new_mesh)


class HostMonitor:
    """File-based heartbeat over a shared directory.

    Each host writes ``beat-{host}-{round}`` at the top of every round;
    :meth:`gate` then waits (up to ``timeout_s``) for every peer's beat
    for that round and returns the hosts that never produced one. Death
    is sticky: a host declared dead is never waited on again. A shared
    filesystem is the one medium that survives the peer's process — the
    in-band channel (collectives) is what a dead host breaks.
    """

    def __init__(self, directory: str, *, host: int, n_hosts: int,
                 timeout_s: float = 30.0, poll_s: float = 0.05,
                 telemetry=None, chaos=None):
        self.directory = directory
        self.host = int(host)
        self.n_hosts = int(n_hosts)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.telemetry = telemetry      # optional repro_torch.obs.Telemetry
        self.chaos = chaos              # optional chaos.FaultSchedule
        self.dead: Set[int] = set()
        # seconds the last gate() waited for its peers
        self.last_wait_s = 0.0
        os.makedirs(directory, exist_ok=True)

    def _beat_path(self, host: int, rnd: int) -> str:
        return os.path.join(self.directory, f"beat-{host}-{rnd}")

    def beat(self, rnd: int) -> None:
        if self.chaos is not None:       # injected straggler delay
            self.chaos.heartbeat(rnd)
        path = self._beat_path(self.host, rnd)
        with open(path + ".tmp", "w") as f:      # atomic publish
            f.write(str(time.time()))
        os.replace(path + ".tmp", path)

    def gate(self, rnd: int) -> Tuple[int, ...]:
        """Beat for ``rnd``, wait for live peers' beats, return newly
        dead hosts (empty tuple = everyone alive)."""
        self.beat(rnd)
        t0 = time.monotonic()
        waiting = {h for h in range(self.n_hosts)
                   if h != self.host and h not in self.dead}
        deadline = t0 + self.timeout_s
        while waiting and time.monotonic() < deadline:
            waiting = {h for h in waiting
                       if not os.path.exists(self._beat_path(h, rnd))}
            if waiting:
                time.sleep(self.poll_s)
        self.last_wait_s = time.monotonic() - t0
        newly_dead = tuple(sorted(waiting))
        self.dead |= waiting
        if newly_dead and self.telemetry is not None:
            self.telemetry.emit(
                "host_death", round=int(rnd),
                dead_hosts=list(newly_dead),
                all_dead=sorted(self.dead),
                timeout_s=self.timeout_s)
        return newly_dead
