"""Public GAE op matching ``repro_torch.marl.gae.gae``'s contract — the
port of ``repro/kernels/gae/ops.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.gae import kernel as k_mod


def gae(rewards, values, dones, last_value, *, gamma: float = 0.99,
        lam: float = 0.95):
    """rewards/values/dones: (..., T); last_value: (...,). Returns
    (advantages, returns) in ``values.dtype``; differentiable in
    rewards/values/last_value through the adjoint kernel."""
    shape = rewards.shape
    t = shape[-1]
    flat = lambda x: x.reshape(-1, t).float().t().contiguous()    # (T, B)
    rw, vl, dn = flat(rewards), flat(values), flat(dones)
    nv = torch.cat([vl[1:], last_value.reshape(1, -1).float()], dim=0)
    adv = k_mod.gae_reverse_scan(rw, vl, nv.contiguous(), dn,
                                 gamma=gamma, lam=lam)
    # the scan runs in f32; cast back so reduced-precision inputs do not
    # silently widen through the kernel path
    adv = adv.t().reshape(shape).to(values.dtype)
    return adv, adv + values
