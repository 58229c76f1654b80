"""Supply-chain env — the port of ``repro/envs/supplychain.py``.

``n_cells`` agents form a production line; cell i holds raw parts in an
input store and finished parts in an output buffer, both capped at
``buf``. Each step a cell first tries to hand its oldest finished part
downstream (blocked when the downstream store is full), then, if its
agent works, it has a raw part and output space and its machine did not
break down, converts one raw part. The head receives raw parts from an
arrival process; the tail ships into a sink. Reward = parts shipped
minus a holding cost per stored part. Agent i's influence sources are
``[upstream_handoff, downstream_backpressure]``, computed from the
PRE-step global state.

Every function takes any leading batch dimensions on its keys and states
(the reference is written for one env and vmapped). :func:`cell_step` is
shared verbatim between GS and LS, so the LS replays the GS exactly
(Definition 3). ``region_partition`` and ``boundary_influence`` (the
sharded GS's) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.envs import registry
from repro_torch.envs.base import EnvInfo


@dataclasses.dataclass(frozen=True)
class SupplyChainConfig:
    n_cells: int = 4              # line length = number of agents
    buf: int = 4                  # capacity of input store AND output buffer
    p_arrival: float = 0.6        # raw-part arrival probability at the head
    p_break: float = 0.1          # per-step machine breakdown probability
    hold_cost: float = 0.02       # WIP holding cost per stored part
    horizon: int = 100

    @property
    def n_agents(self) -> int:
        return self.n_cells

    def info(self) -> EnvInfo:
        obs_dim = 2 * (self.buf + 1)
        return EnvInfo(name="supplychain", n_agents=self.n_agents,
                       obs_dim=obs_dim, n_actions=2, n_influence=2,
                       horizon=self.horizon, alsh_dim=obs_dim + 2)


# ---------------------------------------------------------------------------
# Shared per-cell transition (the \dot{T}_i of the IALM)
# ---------------------------------------------------------------------------
def cell_step(store, buffer, action, u, breakdown, cfg: SupplyChainConfig):
    """Workcells for one step, batched over leading dims.

    store, buffer (...) int in [0, buf]; action (...) in {0: idle,
    1: work}; u (..., 2) bool [hand-off arrives, downstream backpressure];
    breakdown (...) bool.

    Returns (new_store, new_buffer, reward float32, shipped).
    """
    ub = u.bool()
    # the hand-off is gated on store space: a no-op under GS semantics,
    # but the IALS drives this with AIP-sampled u, which must not push
    # the local state out of [0, buf]
    handoff_in, bp = ub[..., 0] & (store < cfg.buf), ub[..., 1]
    ship = (buffer > 0) & ~bp
    buf_after = buffer - ship.long()
    work = ((action.long() == 1) & (store > 0) & (buf_after < cfg.buf)
            & ~breakdown.bool())
    work_i = work.long()
    new_store = store - work_i + handoff_in.long()
    new_buffer = buf_after + work_i
    # the reference's order in float32: ship - hold_cost * stored, the
    # cost a float32 scalar
    reward = (ship.float() - float(np.float32(cfg.hold_cost))
              * (new_store + new_buffer).float())
    return new_store, new_buffer, reward, ship


def _obs(store, buffer, cfg: SupplyChainConfig):
    one_hot = torch.nn.functional.one_hot
    return torch.cat([one_hot(store, cfg.buf + 1).float(),
                      one_hot(buffer, cfg.buf + 1).float()], dim=-1)


# ---------------------------------------------------------------------------
# Global simulator
# ---------------------------------------------------------------------------
def gs_init(key, cfg: SupplyChainConfig):
    ks = R.split(key, 2)
    n = cfg.n_agents
    return {"store": R.randint(ks[..., 0, :], (n,), 0, cfg.buf + 1),
            "buffer": R.randint(ks[..., 1, :], (n,), 0, cfg.buf + 1),
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def gs_exo(key, cfg: SupplyChainConfig):
    """Exogenous draws: per-cell breakdowns (..., N) + head arrival (...)."""
    ks = R.split(key, 2)
    return {"breakdown": R.bernoulli(ks[..., 0, :], cfg.p_break,
                                     (cfg.n_agents,)),
            "arrival": R.bernoulli(ks[..., 1, :], cfg.p_arrival, ())}


def exo_locals(exo, cfg: SupplyChainConfig):
    """Per-region restriction: only the breakdown bit reaches a cell's
    transition directly (the head arrival enters through u)."""
    return exo["breakdown"]


def gs_influence(state, exo, cfg: SupplyChainConfig):
    """u (..., N, 2) from the PRE-step state: [hand-off in,
    backpressure]."""
    store, buffer = state["store"], state["buffer"]
    full = store >= cfg.buf                                  # (..., N)
    # backpressure: downstream input store is full (the tail ships to a
    # sink)
    bp = torch.cat([full[..., 1:], torch.zeros_like(full[..., :1])], dim=-1)
    # every cell's outgoing hand-off this step, by the shared ship rule
    ship = (buffer > 0) & ~bp
    head_in = exo["arrival"] & ~full[..., 0]
    handoff_in = torch.cat([head_in[..., None], ship[..., :-1]], dim=-1)
    return torch.stack([handoff_in, bp], dim=-1)             # (..., N, 2)


def gs_step_given(state, actions, exo, cfg: SupplyChainConfig):
    """Deterministic GS step given the exogenous draws."""
    u = gs_influence(state, exo, cfg)
    new_store, new_buffer, rewards, _ = cell_step(
        state["store"], state["buffer"], actions, u, exo["breakdown"], cfg)
    new_state = {"store": new_store, "buffer": new_buffer,
                 "t": state["t"] + 1}
    done = new_state["t"] >= cfg.horizon
    return (new_state, _obs(new_store, new_buffer, cfg), rewards, u.float(),
            done)


def gs_step(state, actions, key, cfg: SupplyChainConfig):
    return gs_step_given(state, actions, gs_exo(key, cfg), cfg)


def gs_obs(state, cfg: SupplyChainConfig):
    return _obs(state["store"], state["buffer"], cfg)


def gs_locals(state, cfg: SupplyChainConfig):
    """Per-agent local states (..., N) for dataset collection."""
    return {"store": state["store"], "buffer": state["buffer"]}


# ---------------------------------------------------------------------------
# Local simulator (one workcell; hand-offs driven by the AIP)
# ---------------------------------------------------------------------------
def ls_init(key, cfg: SupplyChainConfig):
    ks = R.split(key, 2)
    return {"store": R.randint(ks[..., 0, :], (), 0, cfg.buf + 1),
            "buffer": R.randint(ks[..., 1, :], (), 0, cfg.buf + 1),
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def ls_step_given(local, action, u, breakdown, cfg: SupplyChainConfig):
    """breakdown (...): the region's exogenous machine-failure draw."""
    new_store, new_buffer, reward, _ = cell_step(
        local["store"], local["buffer"], action, u, breakdown, cfg)
    new = {"store": new_store, "buffer": new_buffer, "t": local["t"] + 1}
    done = new["t"] >= cfg.horizon
    return new, _obs(new_store, new_buffer, cfg), reward, done


def ls_step(local, action, u, key, cfg: SupplyChainConfig):
    """u (..., 2): influence-source bits (sampled from the AIP)."""
    breakdown = R.bernoulli(key, cfg.p_break, ())
    return ls_step_given(local, action, u, breakdown, cfg)


def ls_obs(local, cfg: SupplyChainConfig):
    return _obs(local["store"], local["buffer"], cfg)


registry.register(
    "supplychain", sys.modules[__name__], SupplyChainConfig(),
    sizer=lambda cfg, side: dataclasses.replace(cfg, n_cells=side * side))
