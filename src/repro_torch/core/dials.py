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

With ``ckpt_dir`` the state is checkpointed after every round
(``repro_torch.checkpoint``, the reference's layout) with the per-agent
``reports`` vector, and ``run`` resumes from the newest valid step: the
rounds after a restore are those of the uninterrupted run.

Not ported yet, and refused rather than ignored: the async collect,
telemetry sinks, the sharded runtime and the region-decomposed GS.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

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
    max_aip_staleness: int = 2     # rounds; straggler tolerance
    async_collect: bool = False    # not ported: must stay False
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    shards: Optional[int] = None   # only the single-device path: <= 1/None
    sharded_gs: str = "auto"       # "on" needs the sharded runtime
    use_kernels: str = "auto"      # "on"/"off" override the sub-configs
    telemetry_dir: Optional[str] = None  # not ported: must stay None


def _refuse_unported(cfg: DIALSConfig) -> None:
    unported = {"async_collect=True": cfg.async_collect,
                "telemetry_dir": cfg.telemetry_dir is not None,
                "shards>1": cfg.shards is not None and cfg.shards > 1,
                "sharded_gs='on'": cfg.sharded_gs == "on"}
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"not ported yet: {', '.join(asked)} (the port runs the "
            f"single-device loop driver only)")
    if cfg.sharded_gs not in ("auto", "on", "off"):
        raise ValueError(
            f"sharded_gs must be auto|on|off, got {cfg.sharded_gs!r}")


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
        _refuse_unported(cfg)
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- Algorithm 1 --------------------------------------------------------
    def run(self, key, *, state=None, log: Optional[Callable] = None,
            straggler_mask: Optional[Callable] = None):
        """Runs rounds ``state["round"] .. outer_rounds-1`` of (collect ->
        AIP train -> F inner steps -> GS eval). ``state`` starts from a
        given state (e.g. one carried over from the JAX package by
        ``repro_torch.convert``) instead of :meth:`restore_or_init`.
        ``straggler_mask(round) -> (N,) {0,1}`` simulates late AIP
        updates. Returns (state, history of round records); every phase
        ends in a device synchronise, so the phase seconds are device
        time."""
        cfg, n = self.cfg, self.info.n_agents
        key = key.to(self.device)
        if state is None:
            state = self.restore_or_init(key)
        else:
            state, self._resume_extra = dict(state), {}
        kernels = obs_metrics.kernel_summary(
            self.policy_cfg, self.aip_cfg, self.ppo_cfg, self.device)
        # collection round of each agent's newest trained-on dataset,
        # checkpointed so a resume keeps the schedule
        reports = self._restored_reports(state)
        history = []
        t_start = time.time()
        for rnd in range(state["round"], cfg.outer_rounds):
            t_round = time.perf_counter()
            ks = R.split(R.fold_in(state["key"], rnd), 3)
            kc, kt, ke = ks[0], ks[1], ks[2]
            phases = {}

            t0 = time.perf_counter()
            data = self._ring.collect(state["ials"]["params"], kc)
            self._sync()
            phases["collect"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            mask = (torch.as_tensor(straggler_mask(rnd), dtype=torch.float32,
                                    device=self.device)
                    if straggler_mask is not None
                    else torch.ones((n,), device=self.device))
            (state["aips"], reports, ce_before, ce_after,
             forced) = self.aip_round(state["aips"], data, R.split(kt, n),
                                      mask, reports, rnd, rnd)
            stale_forced = int(forced.sum())
            self._sync()
            phases["aip_train"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            metrics = None
            for _ in range(cfg.aip_refresh):
                state["ials"], metrics = self.ials_train(state["ials"],
                                                         state["aips"])
            self._sync()
            phases["inner_steps"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            ret = self.gs_eval(state["ials"]["params"], ke,
                               episodes=cfg.eval_episodes)
            self._sync()
            phases["gs_eval"] = time.perf_counter() - t0

            stats = obs_metrics.staleness_stats(reports, rnd)
            env_steps = collect_stream_count(cfg) * cfg.collect_steps
            rec = obs_metrics.round_record(
                round=rnd, gs_return=ret,
                ials_reward=None if metrics is None else metrics["reward"],
                aip_ce_before=ce_before.mean(),
                aip_ce_after=ce_after.mean(),
                data_round=rnd, forced_sync=False,
                stale_forced=stale_forced,
                staleness_min=stats["staleness_min"],
                staleness_mean=stats["staleness_mean"],
                staleness_max=stats["staleness_max"],
                n_shards=1, reassigned=0, dead_hosts=[], kernels=kernels,
                collect_s=phases["collect"],
                env_steps_per_s=env_steps / phases["collect"],
                aip_s=phases["aip_train"], inner_s=phases["inner_steps"],
                eval_s=phases["gs_eval"], mirror_s=None,
                round_s=time.perf_counter() - t_round,
                wall_s=time.time() - t_start)
            history.append(rec)
            if log:
                log(rec)
            state["round"] = rnd + 1
            if self.manager is not None:
                # beyond the state, an exact resume needs the per-agent
                # data-report rounds (staleness bookkeeping)
                self.manager.save(rnd + 1, state,
                                  extra={"reports": reports.tolist()})
        if self.manager is not None:
            self.manager.wait()
        return state, history
