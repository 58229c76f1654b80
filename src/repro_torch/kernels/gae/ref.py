"""Plain torch version of the GAE scan kernel (``kernel.gae_reverse_scan``):
the same recursion as a loop over T. The kernel's CPU path and its oracle
on the card; autograd gives its backward."""
from __future__ import annotations

import torch


def gae_reverse_scan(rewards, values, next_values, dones, *, gamma: float,
                     lam: float):
    """All inputs (T, B) float32, time-major. Returns advantages (T, B):
    delta_t = r_t + gamma nv_t (1-d_t) - v_t,
    A_t = delta_t + gamma lam (1-d_t) A_{t+1}."""
    carry = torch.zeros_like(rewards[0])
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nd = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values[t] * nd - values[t]
        carry = delta + gamma * lam * nd * carry
        advs.append(carry)
    return torch.stack(advs[::-1])
