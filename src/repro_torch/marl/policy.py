"""Actor-critic policy networks — the port of ``repro/marl/policy.py``.

Params are per-agent stacks with a leading agent axis A (the reference
vmaps one agent's network over agents); inputs are (A, ..., O). This
slice carries the FNN policy every repo configuration uses; the
recurrent policy (``kind="gru"``) comes with the next slice and raises
here.
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
    kind: str = "fnn"             # fnn (the GRU policy is not ported yet)
    hidden: Tuple[int, ...] = (256, 128)
    gru_hidden: int = 128
    use_kernels: str = "auto"     # GRU scan of the recurrent policy:
    #                               auto (kernel on CUDA) | on | off

    def __post_init__(self):
        if self.kind != "fnn":
            raise NotImplementedError(
                f"policy kind {self.kind!r} is not ported yet (fnn only)")


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
    return {"trunk": trunk,
            "pi": dense_init(keys[..., 4, :], din, cfg.n_actions, scale=0.01),
            "v": dense_init(keys[..., 5, :], din, 1, scale=1.0)}


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
    return dense(params["pi"], x), dense(params["v"], x)[..., 0], h


def policy_sequence(params, obs_seq, h0, reset_mask, cfg: PolicyConfig):
    """Recompute over a rollout chunk for PPO. obs_seq (A, B, T, O).
    Returns (logits (A,B,T,nA), values (A,B,T))."""
    del h0, reset_mask                 # the FNN policy carries no state
    x = _trunk(params, obs_seq)
    return dense(params["pi"], x), dense(params["v"], x)[..., 0]


def sample_action(key, logits):
    """Categorical draw per key (keys (..., 2) batch the leading dims of
    ``logits``). Returns (action, log-prob)."""
    a = R.categorical(key, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return a, torch.gather(logp, -1, a[..., None])[..., 0]
