"""GAE scan on the card — wrappers of ``csrc/gae.cu``.

Replaces ``repro/kernels/gae/kernel.py``: ``forward`` launches ``gae_fwd``
(for ``_gae_forward``), ``backward`` launches ``gae_bwd`` (for
``_gae_backward``), and :class:`GAEScan` pairs them as one
``torch.autograd.Function``. The recursion is linear in (r, v, nv), so
the backward needs only the dones: dr = ā, dv = -ā, dnv = γ(1-d)ā, and
dones get no gradient. ``LAUNCHES`` counts the launches of each wrapper,
``SHAPE_LAUNCHES`` the same launches by (T, B).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.gae import ref

LAUNCHES = {"gae_forward": 0, "gae_backward": 0}
SHAPE_LAUNCHES = {"gae_forward": {}, "gae_backward": {}}


def _count(name: str, shape) -> None:
    LAUNCHES[name] += 1
    SHAPE_LAUNCHES[name][shape] = SHAPE_LAUNCHES[name].get(shape, 0) + 1


def forward(rewards, values, next_values, dones, gamma: float, lam: float):
    """Launch the reverse-time scan: advantages (T, B)."""
    shape = rewards.shape
    for name, x in (("rewards", rewards), ("values", values),
                    ("next_values", next_values), ("dones", dones)):
        check_tensor(name, x, shape)
    ext = build.extension()
    adv = torch.empty(shape, dtype=torch.float32, device=rewards.device)
    ext.gae_forward(rewards, values, next_values, dones, adv, gamma,
                    gamma * lam)
    _count("gae_forward", tuple(shape))
    return adv


def backward(g, dones, gamma: float, lam: float):
    """Launch the forward-time adjoint: (dr, dnv), both (T, B)."""
    check_tensor("g", g, dones.shape)
    check_tensor("dones", dones, dones.shape)
    ext = build.extension()
    dr = torch.empty_like(g)
    dnv = torch.empty_like(g)
    ext.gae_backward(g, dones, dr, dnv, gamma, gamma * lam)
    _count("gae_backward", tuple(dones.shape))
    return dr, dnv


class GAEScan(torch.autograd.Function):
    """adv = scan(r, v, nv, d), differentiable in (r, v, nv)."""

    @staticmethod
    def forward(ctx, rewards, values, next_values, dones, gamma, lam):
        ctx.save_for_backward(dones)
        ctx.gamma, ctx.lam = gamma, lam
        return forward(rewards, values, next_values, dones, gamma, lam)

    @staticmethod
    def backward(ctx, g):
        dones, = ctx.saved_tensors
        dr, dnv = backward(g.contiguous(), dones, ctx.gamma, ctx.lam)
        return dr, -dr, dnv, None, None, None


def gae_reverse_scan(rewards, values, next_values, dones, *, gamma: float,
                     lam: float):
    """All inputs (T, B) float32, time-major. Returns advantages (T, B).
    CUDA tensors run the kernels; CPU tensors run the plain version."""
    if rewards.is_cuda:
        return GAEScan.apply(rewards, values, next_values, dones,
                             float(gamma), float(lam))
    return ref.gae_reverse_scan(rewards, values, next_values, dones,
                                gamma=gamma, lam=lam)
