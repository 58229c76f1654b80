"""GS evaluation — the ``eval_fn`` of ``repro/marl/runner.py``'s
``make_gs_trainer``: the paper's periodic evaluation protocol, the mean
per-agent return of the greedy joint policy on the global simulator."""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.marl import policy as policy_mod


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
        h = policy_mod.initial_hidden(policy_cfg, info.n_agents, episodes,
                                      device=dev)
        rews = []
        for k in R.split(ks[1], info.horizon):
            logits, _, h = policy_mod.policy_apply(
                params, obs.transpose(0, 1), h, policy_cfg)
            action = torch.argmax(logits, dim=-1).transpose(0, 1)
            env, obs, rew, _, _ = env_mod.gs_step(
                env, action, R.split(k, episodes), env_cfg)
            rews.append(rew)
        return torch.stack(rews).mean()

    return eval_fn
