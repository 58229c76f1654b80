"""PPO — the port of ``repro/marl/ppo.py``, for per-agent stacks.

Every agent optimises its own loss on its own minibatches: params and the
trajectory carry a leading agent axis A, the loss is computed per agent,
and the gradient of their sum is each agent's own gradient (the
reference's ``vmap`` over agents).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.marl import policy as policy_mod
from repro_torch.optim import adamw, clip as clip_mod
from repro_torch.tree import leaves, take_rows, unflatten_like


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 2.5e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.1
    entropy_coef: float = 1e-2
    value_coef: float = 1.0
    epochs: int = 3
    minibatches: int = 4
    max_grad_norm: float = 0.5
    use_kernels: str = "auto"     # GAE scan in the inner step:
    #                               auto (kernel on CUDA) | on | off


def _agent_mean(x):
    return x.reshape(x.shape[0], -1).mean(-1)


def ppo_loss(params, batch, policy_cfg: policy_mod.PolicyConfig,
             cfg: PPOConfig):
    """batch: obs (A,B,T,O), actions (A,B,T), logp_old, adv, ret,
    values_old, resets (A,B,T), h0 (A,B,H). Returns per-agent (A,) loss
    and metrics."""
    logits, values = policy_mod.policy_sequence(
        params, batch["obs"], batch["h0"], batch["resets"], policy_cfg)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, batch["actions"][..., None])[..., 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["adv"]
    flat = adv.reshape(adv.shape[0], -1)
    mean = flat.mean(-1)
    std = flat.std(-1, unbiased=False)
    shape = (-1,) + (1,) * (adv.ndim - 1)
    adv = (adv - mean.reshape(shape)) / (std.reshape(shape) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    pi_loss = -_agent_mean(torch.minimum(unclipped, clipped))

    v_clip = batch["values_old"] + torch.clamp(
        values - batch["values_old"], -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * _agent_mean(torch.maximum(
        (values - batch["ret"]) ** 2, (v_clip - batch["ret"]) ** 2))

    entropy = _agent_mean(-(torch.exp(logp_all) * logp_all).sum(-1))
    loss = pi_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    ratio_max = ratio.reshape(ratio.shape[0], -1).max(-1).values
    return loss, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": entropy,
                  "ratio_max": ratio_max}


def ppo_update(params, opt_state, traj, key,
               policy_cfg: policy_mod.PolicyConfig, cfg: PPOConfig):
    """traj leaves (A, E, T, ...) (plus h0 (A, E, H)); key (A, 2). Runs
    epochs x minibatches steps. Returns (params, opt_state, metrics), the
    metrics (A,) means over all steps."""
    n_envs = traj["obs"].shape[1]
    mb = max(1, n_envs // cfg.minibatches)
    opt_cfg = adamw.AdamWConfig(b1=0.9, b2=0.999, weight_decay=0.0)
    history = []
    ekeys = R.split(key, cfg.epochs)
    for e in range(cfg.epochs):
        perm = R.permutation(ekeys[..., e, :], n_envs)
        idxs = perm[:, :cfg.minibatches * mb].reshape(-1, cfg.minibatches,
                                                      mb)
        for j in range(cfg.minibatches):
            batch = take_rows(traj, idxs[:, j])
            flat = [p.detach().requires_grad_() for p in leaves(params)]
            with torch.enable_grad():
                loss, metrics = ppo_loss(unflatten_like(params, flat), batch,
                                         policy_cfg, cfg)
                grads = torch.autograd.grad(loss.sum(), flat)
            grads, gnorm = clip_mod.clip_by_global_norm(
                unflatten_like(params, list(grads)), cfg.max_grad_norm)
            master, opt_state = adamw.update(grads, opt_state, cfg.lr,
                                             opt_cfg)
            params = adamw.cast_like(master, params)
            history.append({**{k: v.detach() for k, v in metrics.items()},
                            "loss": loss.detach(), "gnorm": gnorm})
    metrics = {k: torch.stack([h[k] for h in history]).mean(0)
               for k in history[0]}
    return params, opt_state, metrics
