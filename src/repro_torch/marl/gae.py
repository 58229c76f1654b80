"""Generalized Advantage Estimation — the port of ``repro/marl/gae.py``.

The plain torch oracle (a reverse loop over T); ``repro_torch.kernels.gae``
holds the CUDA scan kernels validated against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def gae(rewards, values, dones, last_value, *, gamma: float = 0.99,
        lam: float = 0.95, use_kernels="off"):
    """rewards/values/dones: (..., T); last_value: (...,).

    ``dones[t]`` marks that the episode ended AT step t (no bootstrap
    across it). Returns (advantages, returns) with returns = adv + values.
    ``use_kernels`` routes to the CUDA scan; the default ``"off"`` keeps
    this the oracle. The scan accumulates in f32 whatever the input
    precision and casts back to ``values.dtype``.
    """
    if dispatch.use_kernel(use_kernels, rewards.device):
        from repro_torch.kernels.gae import ops as gae_ops
        return gae_ops.gae(rewards, values, dones, last_value,
                           gamma=gamma, lam=lam)
    rw = rewards.float()
    vl = values.float()
    dn = dones.float()
    next_values = torch.cat([vl[..., 1:], last_value[..., None].float()],
                            dim=-1)
    carry = torch.zeros_like(last_value, dtype=torch.float32)
    advs = []
    for t in range(rw.shape[-1] - 1, -1, -1):
        d = dn[..., t]
        delta = rw[..., t] + gamma * next_values[..., t] * (1.0 - d) \
            - vl[..., t]
        carry = delta + gamma * lam * (1.0 - d) * carry
        advs.append(carry)
    advs = torch.stack(advs[::-1], dim=-1).to(values.dtype)
    return advs, advs + values
