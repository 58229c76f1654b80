"""GRU — the port of ``repro/nn/gru.py``: the plain torch oracle for the
cell and the sequence, and the router onto the CUDA kernels
(``repro_torch.kernels.gru``).

Params carry a leading agent axis A: wi (A,in,3H), wh (A,H,3H), bi/bh
(A,3H), gates fused as [reset | update | candidate]. Inputs are
(A, B, in) for the cell and (A, B, T, in) for the sequence.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.kernels import dispatch
from repro_torch.nn import init as initializers


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    in_dim: int
    hidden: int


def gru_init(key, cfg: GRUConfig):
    """key (A, 2) -> params with leading agent axis A."""
    ks = R.split(key, 2)
    h3 = 3 * cfg.hidden
    zeros = torch.zeros(key.shape[:-1] + (h3,), device=key.device)
    return {"wi": initializers.fan_in_normal(0)(ks[..., 0, :],
                                                (cfg.in_dim, h3)),
            "wh": initializers.orthogonal()(ks[..., 1, :], (cfg.hidden, h3)),
            "bi": zeros, "bh": zeros.clone()}


def agent_matmul(x, w):
    """Per-agent x.w: x (A, ..., din), w (A, din, dout)."""
    a = x.shape[0]
    y = torch.matmul(x.reshape(a, -1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def agent_bias(b, ndim):
    """A per-agent bias (A, dout) shaped to broadcast against (A, ..., dout)
    of rank ``ndim``."""
    return b.reshape(b.shape[:1] + (1,) * (ndim - 2) + b.shape[1:])


def gru_cell(params, h, x, use_kernels="off"):
    """One step. h (A, B, H); x (A, B, in). Returns new h.

    ``use_kernels`` routes the step to the scan kernel at T=1
    (``repro_torch.kernels.gru.ops.gru_cell``); the default ``"off"`` keeps
    this the plain oracle."""
    if dispatch.use_kernel(use_kernels, x.device):
        from repro_torch.kernels.gru import ops as gru_ops
        return gru_ops.gru_cell(params, h, x)
    hdim = params["wh"].shape[1]
    gi = agent_matmul(x, params["wi"]) + agent_bias(params["bi"], x.ndim)
    gh = agent_matmul(h, params["wh"]) + agent_bias(params["bh"], h.ndim)
    r = torch.sigmoid(gi[..., :hdim] + gh[..., :hdim])
    z = torch.sigmoid(gi[..., hdim:2 * hdim] + gh[..., hdim:2 * hdim])
    n = torch.tanh(gi[..., 2 * hdim:] + r * gh[..., 2 * hdim:])
    return (1.0 - z) * n + z * h


def gru_sequence(params, xs, h0=None, *, reset_mask=None,
                 use_kernels="off"):
    """xs (A, B, T, in) -> (hs (A, B, T, H), h_last (A, B, H)).

    ``reset_mask`` (A, B, T) of {0,1}: 1 resets the hidden state *before*
    consuming that step's input. ``use_kernels`` routes the whole sequence
    to the scan kernels."""
    if dispatch.use_kernel(use_kernels, xs.device):
        from repro_torch.kernels.gru import ops as gru_ops
        return gru_ops.gru_sequence(params, xs, h0, reset_mask=reset_mask)
    a, b, t, _ = xs.shape
    if h0 is None:
        h0 = torch.zeros((a, b, params["wh"].shape[1]), dtype=xs.dtype,
                         device=xs.device)
    h, hs = h0, []
    for i in range(t):
        if reset_mask is not None:
            h = h * (1.0 - reset_mask[:, :, i, None].to(h.dtype))
        h = gru_cell(params, h, xs[:, :, i])
        hs.append(h)
    return torch.stack(hs, dim=2), h
