"""Sharded DIALS runtime — the port of ``repro/core/dials_sharded.py``:
one Algorithm-1 outer round with the agent axis sharded over the ranks
of a ``torch.distributed`` group, one shard per process
(``repro_torch.distributed.runtime``).

Each rank holds the params, optimizer state, AIPs and local simulators
of its block of N/S agents and runs:

* the **per-shard body** (:meth:`ShardedDIALSRunner.shard_body`): the
  held-out CE, AIP training, the bounded-staleness gate and F inner
  IALS+PPO steps, **collective-free by construction** — no c10d op
  between AIP refreshes (the paper's runtime-stays-constant claim,
  checked by :meth:`audit_collectives` through the op recorder);
* the GS collect and the periodic GS eval **region-decomposed** on the
  same ranks (``repro_torch.core.gs_sharded``) whenever the env's
  ``region_partition`` supports the block count
  (``DIALSConfig.sharded_gs``: auto/on/off): block-local dynamics plus
  one halo exchange per step, the dataset born agent-sharded. Every GS
  body may communicate with halo sends and receives only
  (``runtime.HALO_PRIMS``). With the replicated fallback every rank
  gathers the joint policy (``all_gather``) and runs the replicated
  collect and eval, keeping its block of the dataset: the joint-policy
  gather points the reference's partitioner inserts;
* the round record's **cross-shard reductions**: the per-agent CE,
  reward, forced-refresh and report vectors are gathered, and the
  record's means and staleness stats taken over all N agents, as the
  loop driver takes them.

Per-agent randomness is shard-equivariant: the per-agent AIP keys are
``split(kt, N)`` sliced to the block, the IALS keys fold in the absolute
agent id (``repro_torch.core.ials``), so a shard computes what the full
batch computes for its agents.

Not ported yet, and refused by the driver (ROADMAP queue 1 item 9): the
split round's overlapped collect (``async_collect``), distributed
checkpoints, and the elastic path (host loss, reassignment).
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core import dials as dials_mod
from repro_torch.core import gs as gs_mod
from repro_torch.core import gs_sharded
from repro_torch.core import ials as ials_mod
from repro_torch.core import influence
from repro_torch.distributed import collectives
from repro_torch.distributed import fault
from repro_torch.distributed import runtime as runtime_lib
from repro_torch.kernels import dispatch
from repro_torch.marl import runner as runner_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import annotate


class ShardedDIALSRunner:
    """This rank's executor of one Algorithm-1 outer round.

    Built by ``DIALSTrainer`` when its group has more than one rank (or
    a shard count is forced), or directly with a one-shard mesh; it owns
    no training-loop policy: logging and the round loop stay in the
    driver. Every rank of the group must make the same calls in the same
    order: the round communicates.
    """

    def __init__(self, env_mod, env_cfg, policy_cfg, aip_cfg, ppo_cfg, cfg,
                 *, mesh=None, n_shards=None, device="cuda"):
        self.env_mod, self.env_cfg, self.cfg = env_mod, env_cfg, cfg
        policy_cfg, aip_cfg, ppo_cfg = (
            dispatch.override_mode(c, cfg.use_kernels)
            for c in (policy_cfg, aip_cfg, ppo_cfg))
        self.aip_cfg = aip_cfg
        self.info = env_cfg.info()
        self.n_eval_seqs = dials_mod.holdout_sequences(cfg)
        n_agents = self.info.n_agents
        if mesh is None:
            mesh = runtime_lib.shard_mesh(n_shards, device=device)
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        if n_agents % self.n_shards:
            raise ValueError(
                f"{n_agents} agents cannot tile {self.n_shards} shards")
        self.rows = mesh.block(n_agents)

        n_collect = dials_mod.collect_stream_count(cfg)
        self.use_sharded_gs = self._resolve_sharded_gs()
        if self.use_sharded_gs:
            self.collect = gs_sharded.make_sharded_collector(
                env_mod, env_cfg, policy_cfg, n_envs=n_collect,
                steps=cfg.collect_steps, mesh=mesh)
            self.gs_eval = gs_sharded.make_sharded_evaluator(
                env_mod, env_cfg, policy_cfg, mesh=mesh)
        else:
            self._collect_joint = gs_mod.make_collector(
                env_mod, env_cfg, policy_cfg, n_envs=n_collect,
                steps=cfg.collect_steps, device=self.device)
            self._eval_joint = runner_mod.make_gs_eval(
                env_mod, env_cfg, policy_cfg, device=self.device)
            self.collect, self.gs_eval = (self._replicated_collect,
                                          self._replicated_eval)
        self._agent_train = ials_mod.make_agent_trainer(
            env_mod, env_cfg, policy_cfg, aip_cfg, ppo_cfg,
            n_envs=dials_mod.ials_stream_count(cfg),
            rollout_steps=cfg.rollout_steps)

    # -- GS decomposition selection ------------------------------------------
    def _resolve_sharded_gs(self) -> bool:
        mode = self.cfg.sharded_gs
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"sharded_gs must be auto|on|off, got {mode!r}")
        if mode == "off":
            return False
        ok, why = gs_sharded.partition_supported(
            self.env_mod, self.env_cfg, self.n_shards)
        if mode == "on" and not ok:
            raise ValueError(
                f"sharded_gs='on' but the GS cannot decompose into "
                f"{self.n_shards} blocks: {why}")
        return ok

    # -- the replicated GS fallback ------------------------------------------
    def _replicated_collect(self, params, key):
        """Gather the joint policy, run the replicated collect, keep this
        block's rows of the dataset."""
        data = self._collect_joint(
            runtime_lib.fetch_tree(params, self.mesh), key)
        return {k: v[self.rows].contiguous() for k, v in data.items()}

    def _replicated_eval(self, params, key, *, episodes: int = 4):
        """Gather the joint policy and run the replicated GS eval (every
        rank computes the same return)."""
        return self._eval_joint(runtime_lib.fetch_tree(params, self.mesh),
                                key, episodes=episodes)

    # -- the per-shard program -----------------------------------------------
    def shard_body(self, aips, ials, reports, data, aip_keys, fresh_mask,
                   rnd: int, data_round: int):
        """The collective-free section: everything between AIP refreshes.

        Every tensor argument is this shard's block (leading axis
        N/num_shards); ``rnd`` and ``data_round`` are the replicated
        round scalars. Nothing here touches another shard: the freshness
        gate and the masked update are elementwise. Returns (aips, ials,
        reports, ce_before (B,), ce_after (B,), reward (B,), forced
        (B,)); the reward is that of the last inner step (zeros when F
        is 0: no inner step ran)."""
        cfg, aip_cfg = self.cfg, self.aip_cfg
        train_data, eval_data = gs_mod.split_dataset(data, self.n_eval_seqs)
        ce_before = influence.eval_ce(aips, eval_data, aip_cfg)
        forced = torch.zeros_like(fresh_mask)
        if not cfg.untrained:
            new_aips, _ = influence.train_aip(aips, train_data, aip_keys,
                                              aip_cfg)
            eff, reports, forced = fault.freshness_gate(
                fresh_mask, reports, data_round, rnd, cfg.max_aip_staleness)
            aips = fault.masked_tree_update(aips, new_aips, eff)
        ce_after = influence.eval_ce(aips, eval_data, aip_cfg)
        reward = torch.zeros(reports.shape, device=reports.device)
        for _ in range(cfg.aip_refresh):
            ials, metrics = self._agent_train(ials, aips)
            reward = metrics["reward"]
        return aips, ials, reports, ce_before, ce_after, reward, forced

    # -- the shard-train program ---------------------------------------------
    def _round_keys(self, base_key, rnd: int):
        ks = R.split(R.fold_in(base_key, rnd), 3)
        return ks[0], ks[1], ks[2]

    def train_round(self, carry, data, base_key, rnd: int, data_round: int,
                    fresh_mask):
        """carry = {"aips", "ials", "reports"} (this block's); ``data``
        this block's dataset, ``data_round`` its collection round;
        ``fresh_mask`` the full (N,) straggler mask. Returns (carry',
        rec) with rec's values 0-d tensors, the same on every rank."""
        _kc, kt, ke = self._round_keys(base_key, rnd)
        n_agents = self.info.n_agents
        with annotate("shard_train"):
            (aips, ials, reports, ce_before, ce_after, reward,
             forced) = self.shard_body(
                carry["aips"], carry["ials"], carry["reports"], data,
                R.split(kt, n_agents)[self.rows], fresh_mask[self.rows],
                rnd, data_round)
        with annotate("gs_eval"):
            ret = self.gs_eval(ials["params"], ke,
                               episodes=self.cfg.eval_episodes)
        # the record's cross-shard reductions: every per-agent vector
        # gathered, the statistics taken over all N agents
        full = collectives.tree_all_gather(
            {"ce_before": ce_before, "ce_after": ce_after, "reward": reward,
             "forced": forced, "reports": reports}, self.mesh)
        rec = {"gs_return": ret, "ials_reward": full["reward"].mean(),
               "aip_ce_before": full["ce_before"].mean(),
               "aip_ce_after": full["ce_after"].mean(),
               "data_round": data_round,
               "stale_forced": full["forced"].sum(),
               **obs_metrics.staleness_stats(full["reports"], rnd)}
        return {"aips": aips, "ials": ials, "reports": reports}, rec

    def round(self, carry, base_key, rnd: int, fresh_mask):
        """The serial schedule: collect under THIS round's policy
        (data_round = rnd), then the shard-train program."""
        kc, _kt, _ke = self._round_keys(base_key, rnd)
        with annotate("gs_collect"):
            data = self.collect(carry["ials"]["params"], kc)
        return self.train_round(carry, data, base_key, rnd, rnd, fresh_mask)

    # -- placement -----------------------------------------------------------
    def shard_carry(self, carry):
        """This block of a full {"aips", "ials", "reports"} carry."""
        return runtime_lib.shard_agent_tree(carry, self.mesh)

    def unshard_carry(self, carry):
        """The full carry from every block (an all-gather: every rank
        ends up holding every agent's rows)."""
        return runtime_lib.fetch_tree(carry, self.mesh)

    # -- contracts -----------------------------------------------------------
    def contract_programs(self, carry, base_key, rnd: int = 0):
        """The round's programs as ``repro_torch.analysis.contracts.
        Program`` records, wrapping the very methods :meth:`round` calls,
        on this block's ``carry`` and round ``rnd``'s keys: the per-shard
        train body (role ``train_body``) and, with the region-decomposed
        GS, the collect and the eval's body (role ``gs_body``). Building
        them runs one collect (the train body's dataset); recording them
        runs each once more. Every rank must build and check them in the
        same order."""
        from repro_torch.analysis.contracts import Program
        kc, kt, ke = self._round_keys(base_key, rnd)
        data = self.collect(carry["ials"]["params"], kc)
        n_agents = self.info.n_agents
        mask = torch.ones((n_agents,), device=self.device)
        name = f"sharded/{self.info.name}[{self.mesh.rank}/{self.n_shards}]"
        programs = [Program(
            name=f"{name}/shard_body", roles=("train_body",),
            fn=self.shard_body,
            args=(carry["aips"], carry["ials"], carry["reports"], data,
                  R.split(kt, n_agents)[self.rows], mask[self.rows], rnd,
                  rnd))]
        if self.use_sharded_gs:
            programs += [
                Program(name=f"{name}/gs_collect", roles=("gs_body",),
                        fn=self.collect,
                        args=(carry["ials"]["params"], kc)),
                Program(name=f"{name}/gs_eval", roles=("gs_body",),
                        fn=self.gs_eval.body,
                        args=(carry["ials"]["params"], ke,
                              self.cfg.eval_episodes))]
        return programs

    def audit_collectives(self, carry, base_key, rnd: int = 0):
        """The round's communication contract, as one executable check
        through the rule engine: the train body is collective-free, and
        every GS body contains halo sends and receives and nothing else.
        Violations raise with the offending op's source line."""
        from repro_torch.analysis import contracts
        contracts.raise_findings(contracts.run_rules(
            self.contract_programs(carry, base_key, rnd),
            rules=(contracts.CollectiveFree(), contracts.HaloOnly())))
