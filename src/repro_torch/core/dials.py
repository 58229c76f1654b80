"""Algorithm 1 — MARL with Distributed Influence-Augmented Local
Simulators; the port of ``repro/core/dials.py``'s single-device loop
driver.

Each round:
  1. collect per-agent (ALSH, u) datasets from the GS under the current
     joint policy (Algorithm 2; ``repro_torch.core.gs``) into the
     device ring's next slot (``repro_torch.distributed.async_collect``),
  2. the AIP round: held-out CE, all AIPs trained together, the
     bounded-staleness gate, CE again,
  3. F inner steps of IALS rollouts + PPO for every agent at once
     (Algorithm 3; ``repro_torch.core.ials``) with the AIPs frozen,
  4. a greedy GS evaluation,
and emits one round record (``repro_torch.obs.metrics``). The key stream
is the reference's: round r draws from ``split(fold_in(key, r), 3)``.

``async_collect=True`` overlaps round k+1's GS collect with round k's
AIP round and F inner steps: an ``AsyncCollector`` worker thread queues
it on a CUDA stream of its own (a plain thread on the CPU). Round k
trains on the dataset collected under round k-1's entry policy
(``data_round`` in the record: the one-round lag Lemma 2 licenses);
round 0 primes with a blocking collect, and a dataset older than
``max_aip_staleness`` rounds is replaced by a blocking one
(``forced_sync``), so ``max_aip_staleness=0`` is the serial schedule.

Every phase is a span of the tracer (``repro_torch.obs``), fenced by
default (``telemetry_fence``) on the driver's stream only: a fence
waits for the phase's own device work and never for the collect on the
other stream. The phases are measured with telemetry off too;
``telemetry_dir`` adds the per-process JSONL event log (``run_start``,
``collect_obtain``, ``round``, ``run_end``).

With ``ckpt_dir`` the state is checkpointed after every round
(``repro_torch.checkpoint``, the reference's layout) with the per-agent
``reports`` vector and the in-flight collect's round tag
(``async_round``), and ``run`` resumes from the newest valid step: the
rounds after a restore are those of the uninterrupted run. An async
resume re-submits the interrupted run's in-flight collect from the
checkpointed params of the round it was submitted in; when that step has
been rotated away, the first round force-syncs.

With more than one rank in the process group (``repro_torch.
distributed.bootstrap``), or ``shards > 1``, ``run`` dispatches to the
agent-sharded round (``repro_torch.core.dials_sharded``, one shard per
rank, the region-decomposed GS under ``sharded_gs``) on the serial
schedule; its record carries ``n_shards`` and null phase fields, as the
reference's sharded record does. Not ported yet, and refused rather
than ignored (ROADMAP queue 1 item 9): the sharded path's overlapped
collect (``async_collect``) and its checkpoints (``ckpt_dir``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import obs
from repro_torch import random as R
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import gs as gs_mod
from repro_torch.core import ials as ials_mod
from repro_torch.core import influence
from repro_torch.distributed import async_collect as async_mod
from repro_torch.distributed import fault
from repro_torch.kernels import dispatch
from repro_torch.marl import policy as policy_mod
from repro_torch.marl import ppo as ppo_mod
from repro_torch.marl import runner as runner_mod
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass(frozen=True)
class DIALSConfig:
    aip_refresh: int = 50          # F, in inner train iterations
    outer_rounds: int = 4
    collect_envs: int = 8
    collect_steps: int = 128       # per env -> dataset size = envs*steps
    collect_holdout: int = 1       # env streams per agent held out of AIP
    #                                training; eval_ce runs on these
    untrained: bool = False        # paper's untrained-DIALS ablation
    eval_episodes: int = 8
    n_envs: int = 16
    rollout_steps: int = 16
    collect_streams: Optional[int] = None
    ials_streams: Optional[int] = None
    max_aip_staleness: int = 2     # rounds; straggler/async-lag tolerance
    async_collect: bool = False    # overlap round k+1's GS collect with
    #                                round k's inner steps (one-round
    #                                dataset lag, bounded by
    #                                max_aip_staleness)
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    # agent-sharded runtime (repro_torch.core.dials_sharded): None =
    # auto (sharded whenever the process group has more than one rank),
    # <=1 = force the loop path, N = N shards, one per rank (N must be
    # the group's world size)
    shards: Optional[int] = None
    # region-decomposed GS on the sharded path: "auto" whenever the
    # env's region_partition tiles the shard count, "on" requires it,
    # "off" keeps the replicated GS; the loop path always replicates
    sharded_gs: str = "auto"
    use_kernels: str = "auto"      # "on"/"off" override the sub-configs
    telemetry_dir: Optional[str] = None  # JSONL event logs (repro_torch.obs)
    # Fence every phase span on the driver's stream, so the phase seconds
    # include their device work. On by default, unlike the reference's
    # (whose JAX loop avoids host syncs): the port's phase seconds have
    # always been fenced, and PERF.md's round tables compare them.
    telemetry_fence: bool = True


def _refuse_unported(cfg: DIALSConfig, sharded: bool) -> None:
    """The sharded path's options that belong to the fault-tolerance half
    of the sharded runtime, which is not ported yet."""
    if cfg.sharded_gs not in ("auto", "on", "off"):
        raise ValueError(
            f"sharded_gs must be auto|on|off, got {cfg.sharded_gs!r}")
    if not sharded:
        return
    unported = {"async_collect": cfg.async_collect,
                "ckpt_dir": cfg.ckpt_dir is not None}
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"not ported yet: {', '.join(asked)} with the sharded runtime "
            f"(the sharded async collect and distributed checkpoints are "
            f"ROADMAP queue 1 item 9); the loop driver runs them")


def collect_stream_count(cfg: DIALSConfig) -> int:
    return (cfg.collect_streams if cfg.collect_streams is not None
            else cfg.collect_envs)


def ials_stream_count(cfg: DIALSConfig) -> int:
    return cfg.ials_streams if cfg.ials_streams is not None else cfg.n_envs


def holdout_sequences(cfg: DIALSConfig) -> int:
    """Held-out streams per agent, clamped so one remains for training."""
    return max(0, min(cfg.collect_holdout, collect_stream_count(cfg) - 1))


class DIALSTrainer:
    """The loop driver on one device (``device="cuda"`` by default; the
    CPU only when asked for)."""

    def __init__(self, env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                 aip_cfg: influence.AIPConfig, ppo_cfg: ppo_mod.PPOConfig,
                 cfg: DIALSConfig, *, device="cuda"):
        _refuse_unported(cfg, cfg.shards is not None and cfg.shards > 1)
        self.device = dispatch.resolve_device(device)
        self.env_mod, self.env_cfg = env_mod, env_cfg
        policy_cfg, aip_cfg, ppo_cfg = (
            dispatch.override_mode(c, cfg.use_kernels)
            for c in (policy_cfg, aip_cfg, ppo_cfg))
        self.policy_cfg, self.aip_cfg = policy_cfg, aip_cfg
        self.ppo_cfg, self.cfg = ppo_cfg, cfg
        self.info = env_cfg.info()
        self.n_eval_seqs = holdout_sequences(cfg)
        n_collect = collect_stream_count(cfg)
        self.collect = gs_mod.make_collector(
            env_mod, env_cfg, policy_cfg, n_envs=n_collect,
            steps=cfg.collect_steps, device=self.device)
        # the in-place twin and its ring: after the first two rounds a
        # collect writes into the retired slot, allocating no dataset
        self.collect_into = gs_mod.make_collector_into(
            env_mod, env_cfg, policy_cfg, n_envs=n_collect,
            steps=cfg.collect_steps, device=self.device)
        self._ring = async_mod.DeviceRing(
            self.collect_into, lambda: gs_mod.zero_dataset(
                env_cfg, n_envs=n_collect, steps=cfg.collect_steps,
                device=self.device))
        self.ials_init, self.ials_train = ials_mod.make_ials_trainer(
            env_mod, env_cfg, policy_cfg, aip_cfg, ppo_cfg,
            n_envs=ials_stream_count(cfg), rollout_steps=cfg.rollout_steps,
            device=self.device)
        self.gs_eval = runner_mod.make_gs_eval(env_mod, env_cfg, policy_cfg,
                                               device=self.device)
        self.manager = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
                        if cfg.ckpt_dir else None)
        self._resume_extra = {}    # checkpoint extra of the restored step
        self._sharded = None       # lazily-built ShardedDIALSRunner

    # -- the AIP round -------------------------------------------------------
    def aip_round(self, aips, data, aip_keys, fresh_mask, reports, rnd,
                  data_round):
        """Holdout split + held-out CE + AIP training + the bounded-
        staleness gate, as the reference's fused AIP program."""
        train_data, eval_data = gs_mod.split_dataset(data, self.n_eval_seqs)
        ce_before = influence.eval_ce(aips, eval_data, self.aip_cfg)
        forced = torch.zeros_like(fresh_mask)
        if not self.cfg.untrained:
            new_aips, _ = influence.train_aip(aips, train_data, aip_keys,
                                              self.aip_cfg)
            eff, reports, forced = fault.freshness_gate(
                fresh_mask, reports, data_round, rnd,
                self.cfg.max_aip_staleness)
            aips = fault.masked_tree_update(aips, new_aips, eff)
        ce_after = influence.eval_ce(aips, eval_data, self.aip_cfg)
        return aips, reports, ce_before, ce_after, forced

    # -- state --------------------------------------------------------------
    def init(self, key):
        """Fresh state from a key ((2,) int64 on this trainer's device)."""
        ks = R.split(key, 2)
        return {"ials": self.ials_init(ks[0]),
                "aips": influence.aip_init(
                    R.split(ks[1], self.info.n_agents), self.aip_cfg),
                "round": 0, "key": key}

    def restore_or_init(self, key):
        """The newest valid checkpoint of ``ckpt_dir`` (restored into this
        trainer's state structure, dtypes and device), else
        ``init(key)``."""
        state = self.init(key)
        self._resume_extra = {}
        if self.manager is not None:
            tree, step = self.manager.restore_latest(state)
            if tree is not None:
                self._resume_extra = dict(self.manager.last_extra)
                tree["round"] = int(step)
                return tree
        return state

    def _restored_reports(self, state):
        """The resumed ``reports`` vector: the checkpointed one when
        present, else every AIP counted fresh as of the last round."""
        saved = self._resume_extra.get("reports")
        if saved is not None and len(saved) == self.info.n_agents:
            return torch.tensor(saved, dtype=torch.int64, device=self.device)
        return torch.full((self.info.n_agents,), state["round"] - 1,
                          dtype=torch.int64, device=self.device)

    # -- path selection ------------------------------------------------------
    def _select_shards(self) -> int:
        """Shard count for the sharded runtime; 0 = the loop path. The
        group's world size plays the reference's device count."""
        from repro_torch.distributed import runtime as runtime_lib
        cfg, n_agents = self.cfg, self.info.n_agents
        n_dev = runtime_lib.world_size()
        if cfg.shards is not None:
            if cfg.shards <= 1:
                return 0
            if cfg.shards > n_dev:
                raise ValueError(
                    f"shards={cfg.shards} but only {n_dev} process(es) in "
                    f"the group: the port runs one shard per rank (start "
                    f"them through repro_torch.distributed.bootstrap)")
            if n_agents % cfg.shards:
                raise ValueError(
                    f"{n_agents} agents cannot tile {cfg.shards} shards")
            return cfg.shards
        if n_dev <= 1:
            return 0
        s = runtime_lib.choose_shards(n_agents, n_dev)
        return s if s > 1 else 0

    def _sharded_runner(self, n_shards: int):
        from repro_torch.core import dials_sharded
        if self._sharded is None or self._sharded.n_shards != n_shards:
            self._sharded = dials_sharded.ShardedDIALSRunner(
                self.env_mod, self.env_cfg, self.policy_cfg, self.aip_cfg,
                self.ppo_cfg, self.cfg, n_shards=n_shards,
                device=self.device)
        return self._sharded

    # -- key plumbing --------------------------------------------------------
    def _collect_key(self, base_key, rnd: int):
        """The round-``rnd`` collect key of the per-round fold-in stream,
        as the serial round draws it, so async and serial runs draw the
        same collect randomness for a given round."""
        return R.split(R.fold_in(base_key, rnd), 3)[0]

    # -- checkpoint-resume plumbing ------------------------------------------
    def _ckpt_extra(self, collector, reports) -> dict:
        """What a checkpoint carries beyond the state for an exact resume:
        the in-flight async collect's round tag and the per-agent
        data-report rounds (staleness bookkeeping)."""
        return {"async_round": (collector.pending_round
                                if collector is not None else None),
                "reports": reports.tolist()}

    def _params_at_round(self, p: int, state):
        """The joint policy params at the TOP of round ``p``, which the
        interrupted run submitted its tag-``p`` collect with: the step-``p``
        checkpoint (end of round p-1), or the init for p == 0. None when
        step ``p`` was rotated away."""
        if p <= 0:
            return self.init(state["key"])["ials"]["params"]
        tree, _ = self.manager.restore_step(p, self.init(state["key"]))
        return None if tree is None else tree["ials"]["params"]

    def _reprime_collector(self, collector, state) -> bool:
        """Exact async resume: re-submit the interrupted run's in-flight
        collect (same params from the prior checkpoint, same key, same
        round tag), so the resumed staleness schedule is the uninterrupted
        one. False: the first obtain() force-syncs instead (fresher data,
        safe under Lemma 2)."""
        p = self._resume_extra.get("async_round")
        if p is None:
            return False
        params = self._params_at_round(int(p), state)
        if params is None:
            return False
        collector.submit(params, self._collect_key(state["key"], int(p) + 1),
                         int(p))
        return True

    def _make_collector_executor(self, telemetry=obs.DISABLED):
        """The loop path's executor: a worker thread driving the ring's
        collect on its own CUDA stream. The ring's slots are allocated
        here, on the driver's stream, before the worker can touch them."""
        self._ring.allocate()
        return async_mod.AsyncCollector(self._ring.collect, mode="thread",
                                        device=self.device,
                                        telemetry=telemetry)

    # -- Algorithm 1 --------------------------------------------------------
    def run(self, key, *, state=None, log: Optional[Callable] = None,
            straggler_mask: Optional[Callable] = None):
        """Runs rounds ``state["round"] .. outer_rounds-1`` of (collect ->
        AIP train -> F inner steps -> GS eval). ``state`` starts from a
        given state (e.g. one carried over from the JAX package by
        ``repro_torch.convert``) instead of :meth:`restore_or_init`.
        ``straggler_mask(round) -> (N,) {0,1}`` simulates late AIP
        updates. Returns (state, history of round records). An exception
        in the collect worker is raised here, at the harvest. With a
        process group of more than one rank (or ``shards > 1``) every
        rank calls this with the same arguments and runs its shard of the
        round (:meth:`_run_sharded`)."""
        cfg, n = self.cfg, self.info.n_agents
        key = key.to(self.device)
        n_shards = self._select_shards()
        _refuse_unported(cfg, n_shards > 0)
        if state is None:
            state = self.restore_or_init(key)
        else:
            state, self._resume_extra = dict(state), {}
        if n_shards:
            return self._run_sharded(state, n_shards, log=log,
                                     straggler_mask=straggler_mask)
        if cfg.sharded_gs == "on":
            # honour the forced mode instead of silently running the
            # replicated GS: the region-decomposed GS is a sharded program
            raise ValueError(
                "sharded_gs='on' requires the sharded runtime (a process "
                "group of more than one rank, or DIALSConfig.shards > 1); "
                "the single-device loop path always uses the replicated GS")
        tel = obs.maybe(cfg.telemetry_dir, fence=cfg.telemetry_fence)
        # the phases are measured with telemetry off too
        tracer = (tel.tracer if tel.enabled
                  else obs.Tracer(fenced=cfg.telemetry_fence))
        kernels = obs_metrics.kernel_summary(
            self.policy_cfg, self.aip_cfg, self.ppo_cfg, self.device)
        collector = (self._make_collector_executor(tel)
                     if cfg.async_collect else None)
        # collection round of each agent's newest trained-on dataset,
        # checkpointed so a resume keeps the schedule
        reports = self._restored_reports(state)
        if collector is not None and state["round"] > 0 \
                and cfg.max_aip_staleness > 0:
            # re-prime the interrupted in-flight collect; failing that,
            # the first obtain() below force-syncs
            self._reprime_collector(collector, state)
        history = []
        t_start = time.time()
        tel.emit("run_start", path="loop", env=self.info.name, n_shards=1,
                 start_round=state["round"], outer_rounds=cfg.outer_rounds,
                 async_collect=cfg.async_collect, kernels=kernels)
        try:
            for rnd in range(state["round"], cfg.outer_rounds):
                tracer.reset()
                t_round = time.perf_counter()
                ks = R.split(R.fold_in(state["key"], rnd), 3)
                kc, kt, ke = ks[0], ks[1], ks[2]

                # (1) Algorithm 2. Async: take the double buffer's dataset
                # (freshness-gated; round 0 primes with a blocking
                # collect) and launch the NEXT round's collect under THIS
                # round's entry policy, overlapping the rest of the round
                with tracer.span("collect") as sp:
                    if collector is not None:
                        tagged, forced_sync = collector.obtain(
                            rnd, state["ials"]["params"], kc,
                            max_staleness=cfg.max_aip_staleness)
                        # unless the bound forbids any lag (a tag-rnd
                        # dataset could never be consumed at rnd+1)
                        if (rnd + 1 < cfg.outer_rounds and collector.idle()
                                and cfg.max_aip_staleness > 0):
                            collector.submit(
                                state["ials"]["params"],
                                self._collect_key(state["key"], rnd + 1),
                                rnd)
                        data, data_round = tagged.data, tagged.round
                    else:
                        data = self._ring.collect(state["ials"]["params"],
                                                  kc)
                        data_round, forced_sync = rnd, False
                    sp.fence(data)

                # (2) the AIP round: held-out CE, training, the gate
                with tracer.span("aip_train") as sp:
                    mask = (torch.as_tensor(straggler_mask(rnd),
                                            dtype=torch.float32,
                                            device=self.device)
                            if straggler_mask is not None
                            else torch.ones((n,), device=self.device))
                    (state["aips"], reports, ce_before, ce_after,
                     forced) = self.aip_round(state["aips"], data,
                                              R.split(kt, n), mask, reports,
                                              rnd, data_round)
                    stale_forced = int(forced.sum())
                    sp.fence((ce_before, ce_after))

                # (3) F inner IALS+PPO steps, AIPs frozen
                with tracer.span("inner_steps") as sp:
                    metrics = None
                    for _ in range(cfg.aip_refresh):
                        state["ials"], metrics = self.ials_train(
                            state["ials"], state["aips"])
                    sp.fence(state["ials"])

                with tracer.span("gs_eval") as sp:
                    ret = sp.fence(self.gs_eval(
                        state["ials"]["params"], ke,
                        episodes=cfg.eval_episodes))
                phases = tracer.phase_seconds()
                stats = obs_metrics.staleness_stats(reports, rnd)
                # collect throughput on the serial path only: the async
                # span measures the obtain wait, not the simulator
                env_steps = collect_stream_count(cfg) * cfg.collect_steps
                env_rate = (env_steps / phases["collect"]
                            if collector is None else None)
                rec = obs_metrics.round_record(
                    round=rnd, gs_return=ret,
                    ials_reward=(None if metrics is None
                                 else metrics["reward"]),
                    aip_ce_before=ce_before.mean(),
                    aip_ce_after=ce_after.mean(),
                    data_round=data_round, forced_sync=forced_sync,
                    stale_forced=stale_forced,
                    staleness_min=stats["staleness_min"],
                    staleness_mean=stats["staleness_mean"],
                    staleness_max=stats["staleness_max"],
                    n_shards=1, reassigned=0, dead_hosts=[],
                    kernels=kernels, collect_s=phases["collect"],
                    env_steps_per_s=env_rate, aip_s=phases["aip_train"],
                    inner_s=phases["inner_steps"], eval_s=phases["gs_eval"],
                    mirror_s=None, round_s=time.perf_counter() - t_round,
                    wall_s=time.time() - t_start)
                tel.emit_round(rec)
                history.append(rec)
                if log:
                    log(rec)
                state["round"] = rnd + 1
                if self.manager is not None:
                    self.manager.save(rnd + 1, state,
                                      extra=self._ckpt_extra(collector,
                                                             reports))
        finally:
            if collector is not None:
                collector.close()
            tel.emit("run_end", rounds=len(history))
            tel.close()
        if self.manager is not None:
            self.manager.wait()
        return state, history

    # -- the sharded path ----------------------------------------------------
    def _run_sharded(self, state, n_shards: int, *, log, straggler_mask):
        """The same round loop over the shard mesh, serial schedule: each
        round is the runner's collect and shard-train program, and the
        one host read of the round fetches its record (the phase fields
        are null: the round is not fenced phase by phase). Returns the
        full state (gathered on every rank) and the history, the same on
        every rank."""
        cfg = self.cfg
        runner = self._sharded_runner(n_shards)
        n = self.info.n_agents
        base_key = state["key"]
        carry = runner.shard_carry(
            {"aips": state["aips"], "ials": state["ials"],
             "reports": self._restored_reports(state)})
        tel = obs.maybe(cfg.telemetry_dir, fence=cfg.telemetry_fence)
        kernels = obs_metrics.kernel_summary(
            self.policy_cfg, self.aip_cfg, self.ppo_cfg, self.device)
        history = []
        t_start = time.time()
        tel.emit("run_start", path="sharded", env=self.info.name,
                 n_shards=runner.n_shards, start_round=state["round"],
                 outer_rounds=cfg.outer_rounds, async_collect=False,
                 elastic=False, sharded_gs=runner.use_sharded_gs,
                 kernels=kernels)
        try:
            for rnd in range(state["round"], cfg.outer_rounds):
                t_round = time.perf_counter()
                mask = (torch.as_tensor(straggler_mask(rnd),
                                        dtype=torch.float32,
                                        device=self.device)
                        if straggler_mask is not None and not cfg.untrained
                        else torch.ones((n,), device=self.device))
                carry, raw = runner.round(carry, base_key, rnd, mask)
                # the round's one deliberate host read: its record
                raw = {k: float(v) for k, v in raw.items()}
                rec = obs_metrics.round_record(
                    round=rnd, gs_return=raw["gs_return"],
                    ials_reward=(None if cfg.aip_refresh == 0
                                 else raw["ials_reward"]),
                    aip_ce_before=raw["aip_ce_before"],
                    aip_ce_after=raw["aip_ce_after"],
                    data_round=raw["data_round"], forced_sync=False,
                    stale_forced=raw["stale_forced"],
                    staleness_min=raw["staleness_min"],
                    staleness_mean=raw["staleness_mean"],
                    staleness_max=raw["staleness_max"],
                    n_shards=runner.n_shards, reassigned=0, dead_hosts=[],
                    kernels=kernels, collect_s=None, env_steps_per_s=None,
                    aip_s=None, inner_s=None, eval_s=None, mirror_s=None,
                    round_s=time.perf_counter() - t_round,
                    wall_s=time.time() - t_start)
                tel.emit_round(rec)
                history.append(rec)
                if log:
                    log(rec)
        finally:
            tel.emit("run_end", rounds=len(history))
            tel.close()
        full = runner.unshard_carry(carry)
        full.pop("reports", None)     # both paths' state schema
        return {**full, "round": cfg.outer_rounds, "key": base_key}, history
