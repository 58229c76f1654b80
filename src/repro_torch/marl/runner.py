"""Batched multi-agent IPPO on the global simulator — the port of
``repro/marl/runner.py``.

``make_gs_trainer`` trains all N agents jointly on the GS (the paper's
"GS" baseline, Fig. 3): E parallel GS copies roll for T steps an
iteration, then every agent takes its own PPO update, all agents at once
(the reference's vmap over agents is the leading agent axis here).
``make_gs_eval`` is its ``eval_fn``, the paper's periodic evaluation
protocol: the mean per-agent return of the greedy joint policy on the
GS.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.core import env_pool
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.marl import gae as gae_mod
from repro_torch.marl import policy as policy_mod
from repro_torch.marl import ppo as ppo_mod
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class RunConfig:
    n_envs: int = 16
    rollout_steps: int = 16


def make_gs_eval(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig, *,
                 device="cuda"):
    """``eval_fn(params, key, *, episodes) -> mean reward`` (a 0-d
    tensor): deterministic (argmax) actions over full episodes, averaged
    over steps, episodes and agents, on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    info = env_cfg.info()

    @torch.no_grad()
    def eval_fn(params, key, *, episodes: int = 4):
        ks = R.split(key.to(dev), 2)
        env = env_mod.gs_init(R.split(ks[0], episodes), env_cfg)
        obs = env_mod.gs_obs(env, env_cfg)                      # (E, N, O)
        h = policy_mod.initial_hidden(policy_cfg, episodes, info.n_agents,
                                      device=dev)
        rews = []
        for k in R.split(ks[1], info.horizon):
            logits, _, h = policy_mod.policy_apply_streams(params, obs, h,
                                                           policy_cfg)
            action = torch.argmax(logits, dim=-1)
            env, obs, rew, _, _ = env_mod.gs_step(
                env, action, R.split(k, episodes), env_cfg)
            rews.append(rew)
        return torch.stack(rews).mean()

    return eval_fn


def make_gs_trainer(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                    ppo_cfg: ppo_mod.PPOConfig, run_cfg: RunConfig, *,
                    device="cuda"):
    """``(init_fn, train_fn, eval_fn)`` on ``device`` (CUDA unless the
    caller asks for the CPU): ``init_fn(key) -> state``, ``train_fn(state)
    -> (state, scalar metrics)`` (one rollout of E GS copies for T steps
    and one PPO update of every agent), and :func:`make_gs_eval`'s
    ``eval_fn``."""
    dev = resolve_device(device)
    info = env_cfg.info()
    n_agents, n_envs = info.n_agents, run_cfg.n_envs
    pool = env_pool.GSPool(env_mod, env_cfg, n_envs)

    def init_fn(key):
        ks = R.split(key.to(dev), 3)
        params = policy_mod.policy_init(R.split(ks[0], n_agents), policy_cfg)
        env = env_mod.gs_init(R.split(ks[1], n_envs), env_cfg)
        return {"params": params, "opt": adamw.init(params), "env": env,
                "obs": env_mod.gs_obs(env, env_cfg),
                "h": policy_mod.initial_hidden(policy_cfg, n_envs, n_agents,
                                               device=dev),
                "key": ks[2],
                "iter": torch.zeros((), dtype=torch.int64, device=dev)}

    @torch.no_grad()
    def rollout(state):
        """T steps of the E GS copies with auto-reset. Returns the final
        (env, obs, h) and the trajectory, leaves (N, E, T, ...)."""
        env, obs, h = state["env"], state["obs"], state["h"]
        prev_done = torch.zeros((n_envs,), dtype=torch.bool, device=dev)
        traj = []
        for key in R.split(state["key"], run_cfg.rollout_steps):
            ks = R.split(key, 3)
            logits, value, h_new = policy_mod.policy_apply_streams(
                state["params"], obs, h, policy_cfg)
            # one key draws the whole (E, N) joint action, as the
            # reference does here
            action, logp = policy_mod.sample_action(ks[0], logits)
            env, obs2, rew, _, done = pool.step_reset(
                env, action, R.split(ks[1], n_envs),
                R.split(ks[2], n_envs))
            step = {"obs": obs, "action": action, "logp": logp,
                    "value": value, "reward": rew,
                    "done": done[:, None].expand(rew.shape),
                    # marks "a new episode starts at this step" (GRU reset)
                    "reset_pre": prev_done[:, None].expand(rew.shape),
                    "h_pre": h}
            traj.append({k: v.transpose(0, 1) for k, v in step.items()})
            (h,) = env_pool.zero_on_done(done, (h_new,))
            obs, prev_done = obs2, done
        traj = {k: torch.stack([s[k] for s in traj], dim=2)
                for k in traj[0]}
        return (env, obs, h), traj

    def train_fn(state):
        k_iter = R.fold_in(state["key"], state["iter"])
        state = {**state, "key": k_iter}
        (env, obs, h), traj = rollout(state)
        with torch.no_grad():
            # bootstrap value for the state after the last step
            _, last_value, _ = policy_mod.policy_apply_streams(
                state["params"], obs, h, policy_cfg)            # (E, N)
            adv, ret = gae_mod.gae(
                traj["reward"], traj["value"], traj["done"],
                last_value.transpose(0, 1), gamma=ppo_cfg.gamma,
                lam=ppo_cfg.lam, use_kernels=ppo_cfg.use_kernels)
        batch = {"obs": traj["obs"], "actions": traj["action"],
                 "logp_old": traj["logp"], "values_old": traj["value"],
                 "adv": adv, "ret": ret,
                 "resets": traj["reset_pre"].float(),
                 "h0": traj["h_pre"][:, :, 0]}                  # (N, E, H)
        keys = R.split(R.fold_in(k_iter, 1), n_agents)
        params, opt, metrics = ppo_mod.ppo_update(
            state["params"], state["opt"], batch, keys, policy_cfg, ppo_cfg)
        metrics = {k: v.mean() for k, v in metrics.items()}
        metrics["reward"] = traj["reward"].mean()
        return {**state, "params": params, "opt": opt, "env": env,
                "obs": obs, "h": h, "iter": state["iter"] + 1}, metrics

    return init_fn, train_fn, make_gs_eval(env_mod, env_cfg, policy_cfg,
                                           device=dev)
