"""Actor-critic policy networks — the port of ``repro/marl/policy.py``.

Params are per-agent stacks with a leading agent axis A (the reference
vmaps one agent's network over agents); inputs are (A, ..., O). Two
kinds, as in the paper (Table 5): the FNN policy (traffic) and the
recurrent policy (``kind="gru"``, warehouse), whose GRU runs the rollout
cell and the PPO sequence through the scan kernels under
``use_kernels``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch import random as R
from repro_torch.nn import gru as gru_mod
from repro_torch.nn import init as initializers


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    obs_dim: int
    n_actions: int
    kind: str = "fnn"             # fnn | gru
    hidden: Tuple[int, ...] = (256, 128)
    gru_hidden: int = 128
    use_kernels: str = "auto"     # GRU scan of the recurrent policy:
    #                               auto (kernel on CUDA) | on | off


def dense_init(key, din, dout, scale=math.sqrt(2.0)):
    """key (A, 2) -> {"w" (A,din,dout) orthogonal, "b" (A,dout) zeros}."""
    w = initializers.orthogonal(scale)(key, (din, dout))
    return {"w": w, "b": torch.zeros(w.shape[:-2] + (dout,),
                                     device=key.device)}


def dense(p, x):
    """Per-agent x.w + b: x (A, ..., din)."""
    y = gru_mod.agent_matmul(x, p["w"])
    return y + gru_mod.agent_bias(p["b"], y.ndim)


def policy_init(key, cfg: PolicyConfig):
    """key (A, 2) -> per-agent params."""
    keys = R.split(key, 6)
    din = cfg.obs_dim
    trunk = []
    for i, h in enumerate(cfg.hidden):
        trunk.append(dense_init(keys[..., i, :], din, h))
        din = h
    params = {"trunk": trunk}
    if cfg.kind == "gru":
        params["gru"] = gru_mod.gru_init(
            keys[..., 3, :], gru_mod.GRUConfig(in_dim=din,
                                               hidden=cfg.gru_hidden))
        din = cfg.gru_hidden
    params["pi"] = dense_init(keys[..., 4, :], din, cfg.n_actions, scale=0.01)
    params["v"] = dense_init(keys[..., 5, :], din, 1, scale=1.0)
    return params


def initial_hidden(cfg: PolicyConfig, *batch, device=None):
    return torch.zeros(tuple(batch) + (cfg.gru_hidden,), device=device)


def _trunk(params, x):
    for p in params["trunk"]:
        x = torch.relu(dense(p, x))
    return x


def policy_apply(params, obs, h, cfg: PolicyConfig):
    """One step. obs (A, ..., O); h (A, ..., H). Returns (logits, value,
    h')."""
    x = _trunk(params, obs)
    if cfg.kind == "gru":
        a = x.shape[0]
        hf = gru_mod.gru_cell(params["gru"], h.reshape(a, -1, h.shape[-1]),
                              x.reshape(a, -1, x.shape[-1]),
                              use_kernels=cfg.use_kernels)
        h = x = hf.reshape(h.shape)
    return dense(params["pi"], x), dense(params["v"], x)[..., 0], h


def policy_apply_streams(params, obs, h, cfg: PolicyConfig):
    """:func:`policy_apply` on the GS's stream-major layout: obs (S, A, O),
    h (S, A, H) -> (logits, value, h') stream-major."""
    logits, value, h2 = policy_apply(params, obs.transpose(0, 1),
                                     h.transpose(0, 1), cfg)
    return logits.transpose(0, 1), value.transpose(0, 1), h2.transpose(0, 1)


def policy_sequence(params, obs_seq, h0, reset_mask, cfg: PolicyConfig):
    """Recompute over a rollout chunk for PPO. obs_seq (A, B, T, O); h0
    (A, B, H); reset_mask (A, B, T). Returns (logits (A,B,T,nA), values
    (A,B,T))."""
    x = _trunk(params, obs_seq)
    if cfg.kind == "gru":
        x, _ = gru_mod.gru_sequence(params["gru"], x, h0,
                                    reset_mask=reset_mask,
                                    use_kernels=cfg.use_kernels)
    return dense(params["pi"], x), dense(params["v"], x)[..., 0]


def sample_action(key, logits):
    """Categorical draw per key (keys (..., 2) batch the leading dims of
    ``logits``). Returns (action, log-prob)."""
    a = R.categorical(key, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return a, torch.gather(logp, -1, a[..., None])[..., 0]
