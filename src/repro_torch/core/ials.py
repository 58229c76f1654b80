"""Algorithm 3 — influence-augmented local simulators, batched; the port
of ``repro/core/ials.py``.

Each agent trains on its OWN local simulators, whose influence sources
are sampled from its AIP every step: u ~ AIP_i(.|l_i^t), then
x^{t+1} ~ T_i(.|x, a, u). There is no cross-agent interaction inside
the loop, so the agent axis is a batch axis: all N agents' E local sims
step together, with per-agent weights in every matmul and kernel.

Every random draw of agent i derives from its OWN key (``state["key"]
[i]``, fixed at init from the absolute agent id) and each stream's from
its absolute stream index, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.core import env_pool
from repro_torch.core import influence
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.marl import gae as gae_mod
from repro_torch.marl import policy as policy_mod
from repro_torch.marl import ppo as ppo_mod
from repro_torch.optim import adamw


def make_ials_init(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                   aip_cfg: influence.AIPConfig, *, n_envs: int,
                   device="cuda"):
    """Agent-major IALS state init on ``device``: every leaf has leading
    axis N."""
    dev = resolve_device(device)
    n_agents = env_cfg.info().n_agents
    pool = env_pool.LSPool(env_mod, env_cfg, n_envs)

    def init_fn(key):
        ks = R.split(key.to(dev), 3)
        kp, ke, kr = ks[0], ks[1], ks[2]
        params = policy_mod.policy_init(R.split(kp, n_agents), policy_cfg)
        # per-(agent, stream) init chains fold in the ABSOLUTE agent id,
        # then the ABSOLUTE stream id
        locals_ = pool.init(env_pool.stream_keys(
            env_pool.stream_keys(ke, n_agents), n_envs))
        return {
            "params": params, "opt": adamw.init(params), "locals": locals_,
            "obs": pool.obs(locals_),
            "h": policy_mod.initial_hidden(policy_cfg, n_agents, n_envs,
                                           device=dev),
            "aip_h": influence.initial_hidden(aip_cfg, n_agents, n_envs,
                                              device=dev),
            "prev_a": torch.zeros((n_agents, n_envs), dtype=torch.int64,
                                  device=dev),
            "key": R.fold_in(kr, torch.arange(n_agents, device=dev)),
            "iter": torch.zeros((n_agents,), dtype=torch.int64, device=dev),
        }

    return init_fn


def make_agent_trainer(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                       aip_cfg: influence.AIPConfig,
                       ppo_cfg: ppo_mod.PPOConfig, *, n_envs: int,
                       rollout_steps: int):
    """``train_agents(state, aip_params) -> (state, per-agent metrics)``:
    one rollout on every agent's IALS and one PPO update (Algorithm 3
    body) for the A agents of the state it is handed (all N, or a shard's
    block: nothing here reads the env's agent count), on the state's
    device; every metric an (A,) vector (the reference's
    ``make_agent_trainer`` under ``vmap``)."""
    info = env_cfg.info()
    pool = env_pool.LSPool(env_mod, env_cfg, n_envs)

    @torch.no_grad()
    def rollout(state, aip_params, k_roll):
        skeys = env_pool.stream_keys(k_roll, n_envs)         # (N, E, 2)
        locals_, obs, h = state["locals"], state["obs"], state["h"]
        aip_h, prev_a = state["aip_h"], state["prev_a"]
        prev_done = torch.zeros(obs.shape[:2], dtype=torch.bool,
                                device=obs.device)
        traj = []
        for t in range(rollout_steps):
            k_act, k_u, k_env, k_reset = env_pool.step_keys(skeys, t, 4)
            # the AIP consumes (x_t, a_{t-1}) and proposes u_t
            feat = torch.cat([obs, torch.nn.functional.one_hot(
                prev_a, info.n_actions).float()], dim=-1)
            u_logits, aip_h2 = influence.aip_apply(aip_params, feat, aip_h,
                                                   aip_cfg)
            u = influence.sample_sources(k_u, u_logits)
            logits, value, h2 = policy_mod.policy_apply(
                state["params"], obs, h, policy_cfg)
            action, logp = policy_mod.sample_action(k_act, logits)
            locals3, obs3, rew, done = pool.step_reset(
                locals_, action, u, k_env, k_reset)
            h3, aip_h3, prev3 = env_pool.zero_on_done(
                done, (h2, aip_h2, action))
            traj.append({"obs": obs, "action": action, "logp": logp,
                         "value": value, "reward": rew, "done": done,
                         "h_pre": h, "reset_pre": prev_done})
            locals_, obs, h, aip_h, prev_a, prev_done = (
                locals3, obs3, h3, aip_h3, prev3, done)
        # traj leaves (N, E, T, ...)
        traj = {k: torch.stack([s[k] for s in traj], dim=2)
                for k in traj[0]}
        return (locals_, obs, h, aip_h, prev_a), traj

    def train_agents(state, aip_params):
        k_iter = R.fold_in(state["key"], state["iter"])
        # separate roots for the rollout's stream chains and the PPO
        # minibatch shuffle
        ks = R.split(k_iter, 2)
        (locals_, obs, h, aip_h, prev_a), traj = rollout(
            state, aip_params, ks[..., 0, :])
        with torch.no_grad():
            _, last_value, _ = policy_mod.policy_apply(
                state["params"], obs, h, policy_cfg)             # (N, E)
            adv, ret = gae_mod.gae(
                traj["reward"], traj["value"], traj["done"], last_value,
                gamma=ppo_cfg.gamma, lam=ppo_cfg.lam,
                use_kernels=ppo_cfg.use_kernels)
        batch = {"obs": traj["obs"], "actions": traj["action"],
                 "logp_old": traj["logp"], "values_old": traj["value"],
                 "adv": adv, "ret": ret,
                 "resets": traj["reset_pre"].float(),
                 "h0": traj["h_pre"][:, :, 0]}                   # (N, E, H)
        params, opt, metrics = ppo_mod.ppo_update(
            state["params"], state["opt"], batch, ks[..., 1, :],
            policy_cfg, ppo_cfg)
        new_state = {**state, "params": params, "opt": opt,
                     "locals": locals_, "obs": obs, "h": h, "aip_h": aip_h,
                     "prev_a": prev_a, "iter": state["iter"] + 1}
        return new_state, {**metrics,
                           "reward": traj["reward"].mean(dim=(1, 2))}

    return train_agents


def make_ials_trainer(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                      aip_cfg: influence.AIPConfig,
                      ppo_cfg: ppo_mod.PPOConfig, *, n_envs: int,
                      rollout_steps: int, device="cuda"):
    """``(init_fn, train_fn)`` with ``train_fn(state, aip_params (N, ...))
    -> (state, scalar metrics)``: :func:`make_agent_trainer`'s step for
    all agents at once, its metrics meaned over agents. The state lives
    on ``device`` (CUDA unless the caller asks for the CPU)."""
    init_fn = make_ials_init(env_mod, env_cfg, policy_cfg, aip_cfg,
                             n_envs=n_envs, device=device)
    train_agents = make_agent_trainer(
        env_mod, env_cfg, policy_cfg, aip_cfg, ppo_cfg, n_envs=n_envs,
        rollout_steps=rollout_steps)

    def train_fn(state, aip_params):
        state, metrics = train_agents(state, aip_params)
        return state, {k: v.mean() for k, v in metrics.items()}

    return init_fn, train_fn
