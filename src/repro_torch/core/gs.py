"""Algorithm 2 — collect per-agent influence datasets from the GS; the
port of ``repro/core/gs.py``.

Rolls S independent global-simulator streams under the current joint
policy (one batched pool, ``repro_torch.core.env_pool``) and records, for
every agent i, stream s and step t, the ALSH feature (local obs x_i^t ++
one-hot of a_i^{t-1}) and the realised influence sources u_i^t. Each
stream draws its joint action from its OWN step key, so the sampled bits
depend on (key, s, t) and never on S. Each step writes its (S, N, ...)
record into the t-th time slice of (N, S, T, ...) buffers:
:func:`make_collector` allocates them per call, :func:`make_collector_into`
writes into the caller's (``repro_torch.distributed.async_collect.
DeviceRing``'s retired slots), so a steady-state collect allocates no
dataset.
"""
from __future__ import annotations

import torch

from repro_torch.core import env_pool
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.marl import policy as policy_mod
from repro_torch.tree import tree_map


def split_dataset(data, n_eval: int):
    """Split a dataset (leaves (N, S, T, ...)) along S into (train,
    held_out): the LAST ``n_eval`` streams per agent are held out of AIP
    training. ``n_eval <= 0`` returns the full dataset for both. The
    halves are views, not copies."""
    if n_eval <= 0:
        return data, data
    n_seq = data["feats"].shape[1]
    if n_eval >= n_seq:
        raise ValueError(
            f"cannot hold out {n_eval} of {n_seq} collected sequences — "
            f"at least one must remain for AIP training")
    return (tree_map(lambda x: x[:, :n_seq - n_eval], data),
            tree_map(lambda x: x[:, n_seq - n_eval:], data))


def zero_dataset(env_cfg, *, n_envs: int, steps: int, device="cuda"):
    """Zero (N, n_envs, steps, ...) buffers of a collect's dataset: feats,
    u, resets."""
    dev = resolve_device(device)
    info = env_cfg.info()
    shape = (info.n_agents, n_envs, steps)
    return {"feats": torch.zeros(shape + (info.alsh_dim,), device=dev),
            "u": torch.zeros(shape + (info.n_influence,), device=dev),
            "resets": torch.zeros(shape, device=dev)}


def make_collector_into(env_mod, env_cfg,
                        policy_cfg: policy_mod.PolicyConfig,
                        *, n_envs: int, steps: int, device="cuda"):
    """``collect_into(bufs, policy_params, key) -> bufs``: the collect
    written in place into the caller's (N, n_envs, steps, ...) buffers
    (the shapes of :func:`zero_dataset`) on ``device`` (CUDA unless the
    caller asks for the CPU; the params must live there). Every cell is
    overwritten, so the result is independent of what the buffers held."""
    dev = resolve_device(device)
    info = env_cfg.info()
    n_agents = info.n_agents
    pool = env_pool.GSPool(env_mod, env_cfg, n_envs)

    @torch.no_grad()
    def collect_into(bufs, policy_params, key):
        skeys = env_pool.stream_keys(key.to(dev), n_envs)
        env = pool.init(skeys)
        obs = pool.obs(env)
        h = policy_mod.initial_hidden(policy_cfg, n_envs, n_agents,
                                      device=dev)
        prev_a = torch.zeros((n_envs, n_agents), dtype=torch.int64,
                             device=dev)
        prev_done = torch.ones((n_envs,), dtype=torch.bool, device=dev)
        for t in range(steps):
            k_act, k_env, k_reset = env_pool.step_keys(skeys, t, 3)
            feat = torch.cat([obs, torch.nn.functional.one_hot(
                prev_a, info.n_actions).float()], dim=-1)
            logits, _, h2 = policy_mod.policy_apply_streams(
                policy_params, obs, h, policy_cfg)
            action, _ = policy_mod.sample_action(k_act, logits)
            env, obs, _rew, u, done = pool.step_reset(env, action, k_env,
                                                      k_reset)
            h, prev_a = env_pool.zero_on_done(done, (h2, action))
            # the reset flag marks "a new episode starts HERE" (before
            # this feat)
            bufs["feats"][:, :, t].copy_(feat.transpose(0, 1))
            bufs["u"][:, :, t].copy_(u.transpose(0, 1))
            bufs["resets"][:, :, t].copy_(prev_done[None, :].float())
            prev_done = done
        return bufs

    return collect_into


def make_collector(env_mod, env_cfg, policy_cfg: policy_mod.PolicyConfig,
                   *, n_envs: int, steps: int, device="cuda"):
    """``collect(policy_params, key) -> dataset`` with leaves
    (N, n_envs, steps, ...): feats, u, resets, on ``device`` (CUDA unless
    the caller asks for the CPU; the params must live there)."""
    collect_into = make_collector_into(env_mod, env_cfg, policy_cfg,
                                       n_envs=n_envs, steps=steps,
                                       device=device)
    return lambda params, key: collect_into(
        zero_dataset(env_cfg, n_envs=n_envs, steps=steps, device=device),
        params, key)
