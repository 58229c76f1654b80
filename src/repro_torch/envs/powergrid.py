"""Power-grid voltage control env — the port of ``repro/envs/powergrid.py``.

``n_buses`` agents sit on a ring of distribution feeders; agent i owns a
feeder of ``feeder`` nodes whose discrete voltage levels drift under
random load fluctuations. Its on-load tap changer (action: lower / hold
/ raise, a saturating integrator in [-TAP_MAX, TAP_MAX]) shifts the
feeder's voltage; the reward is the fraction of nodes inside the
regulation band. Buses are coupled only through the tie-lines to their
two neighbours, so agent i's influence sources are the four flags
``[left_over, left_under, right_over, right_under]``, computed from the
PRE-step global state.

Every function takes any leading batch dimensions on its keys and states
(the reference is written for one env and vmapped). :func:`bus_step` is
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

TAP_MAX = 2                       # tap positions in [-2, 2] -> 5 one-hot


def _recip(d: int) -> float:
    """1/d in float32. The reference's divisions by a constant compile
    (XLA) to products with this reciprocal, so its values are those."""
    return float(np.float32(1.0) / np.float32(d))


@dataclasses.dataclass(frozen=True)
class PowerGridConfig:
    n_buses: int = 4              # ring length = number of agents
    feeder: int = 6               # nodes per feeder
    v_levels: int = 9             # discrete voltage levels [0, v_levels)
    band: int = 1                 # |v - nominal| <= band is in-band
    p_load: float = 0.4           # per-node load-fluctuation probability
    horizon: int = 100

    @property
    def n_agents(self) -> int:
        return self.n_buses

    @property
    def nominal(self) -> int:
        return (self.v_levels - 1) // 2

    def info(self) -> EnvInfo:
        obs_dim = self.feeder + (2 * TAP_MAX + 1)
        return EnvInfo(name="powergrid", n_agents=self.n_agents,
                       obs_dim=obs_dim, n_actions=3, n_influence=4,
                       horizon=self.horizon, alsh_dim=obs_dim + 3)


# ---------------------------------------------------------------------------
# Shared per-bus transition (the \dot{T}_i of the IALM)
# ---------------------------------------------------------------------------
def bus_step(volts, tap, action, u, load, cfg: PowerGridConfig):
    """Bus regions for one step, batched over leading dims.

    volts (..., F) int node voltage levels; tap (...) in [-2, 2]; action
    (...) in {0: lower, 1: hold, 2: raise}; u (..., 4) bool [left_over,
    left_under, right_over, right_under]; load (..., F) in {-1, 0, +1}.

    Returns (new_volts, new_tap, reward float32).
    """
    ub = u.bool().long()
    new_tap = torch.clamp(tap + action.long() - 1, -TAP_MAX, TAP_MAX)
    # neighbour excursions propagate one level over the tie-lines
    push = (ub[..., 0] + ub[..., 2]) - (ub[..., 1] + ub[..., 3])
    new_volts = torch.clamp(
        volts + load + (new_tap - tap + push)[..., None], 0,
        cfg.v_levels - 1)
    in_band = (new_volts - cfg.nominal).abs() <= cfg.band
    # the reference's mean(dtype=float32): an exact sum times 1/F
    reward = in_band.sum(-1).float() * _recip(cfg.feeder)
    return new_volts, new_tap, reward


def _flags(volts, cfg: PowerGridConfig):
    """(..., F) volts -> (over (...), under (...)) excursion flags."""
    hi = cfg.nominal + cfg.band
    lo = cfg.nominal - cfg.band
    return volts.amax(-1) > hi, volts.amin(-1) < lo


def _obs(volts, tap, cfg: PowerGridConfig):
    return torch.cat([
        volts.float() * _recip(cfg.v_levels - 1),
        torch.nn.functional.one_hot(tap + TAP_MAX, 2 * TAP_MAX + 1).float(),
    ], dim=-1)


def _load(hit, up):
    return torch.where(hit, torch.where(up, 1, -1), 0)


# ---------------------------------------------------------------------------
# Global simulator
# ---------------------------------------------------------------------------
def gs_init(key, cfg: PowerGridConfig):
    nom = cfg.nominal
    batch = key.shape[:-1]
    return {"volts": R.randint(key, (cfg.n_agents, cfg.feeder), nom - 1,
                               nom + 2),
            "tap": torch.zeros(batch + (cfg.n_agents,), dtype=torch.int64,
                               device=key.device),
            "t": torch.zeros(batch, dtype=torch.int64, device=key.device)}


def gs_exo(key, cfg: PowerGridConfig):
    """Exogenous load fluctuations, (..., N, F) in {-1, 0, +1}."""
    ks = R.split(key, 2)
    shape = (cfg.n_agents, cfg.feeder)
    return _load(R.bernoulli(ks[..., 0, :], cfg.p_load, shape),
                 R.bernoulli(ks[..., 1, :], 0.5, shape))


def exo_locals(load, cfg: PowerGridConfig):
    """Per-region restriction of the exogenous draws (already per-bus)."""
    return load


def gs_influence(state, cfg: PowerGridConfig):
    """u (..., N, 4) from the PRE-step volts: neighbour excursion flags."""
    over, under = _flags(state["volts"], cfg)               # (..., N)
    left = lambda x: torch.roll(x, 1, dims=-1)              # x[i-1 mod N]
    right = lambda x: torch.roll(x, -1, dims=-1)            # x[i+1 mod N]
    return torch.stack(
        [left(over), left(under), right(over), right(under)], dim=-1)


def gs_step_given(state, actions, load, cfg: PowerGridConfig):
    """Deterministic GS step given the load draws (..., N, F)."""
    u = gs_influence(state, cfg)                            # (..., N, 4)
    new_volts, new_taps, rewards = bus_step(
        state["volts"], state["tap"], actions, u, load, cfg)
    obs = _obs(new_volts, new_taps, cfg)
    new_state = {"volts": new_volts, "tap": new_taps, "t": state["t"] + 1}
    done = new_state["t"] >= cfg.horizon
    return new_state, obs, rewards, u.float(), done


def gs_step(state, actions, key, cfg: PowerGridConfig):
    return gs_step_given(state, actions, gs_exo(key, cfg), cfg)


def gs_obs(state, cfg: PowerGridConfig):
    return _obs(state["volts"], state["tap"], cfg)


def gs_locals(state, cfg: PowerGridConfig):
    """Per-agent local states (..., N, ...) for dataset collection."""
    return {"volts": state["volts"], "tap": state["tap"]}


# ---------------------------------------------------------------------------
# Local simulator (one bus; neighbour flags driven by the AIP)
# ---------------------------------------------------------------------------
def ls_init(key, cfg: PowerGridConfig):
    nom = cfg.nominal
    batch = key.shape[:-1]
    return {"volts": R.randint(key, (cfg.feeder,), nom - 1, nom + 2),
            "tap": torch.zeros(batch, dtype=torch.int64, device=key.device),
            "t": torch.zeros(batch, dtype=torch.int64, device=key.device)}


def ls_step_given(local, action, u, load, cfg: PowerGridConfig):
    """load (..., F): the region's exogenous draws."""
    new_volts, new_tap, reward = bus_step(
        local["volts"], local["tap"], action, u, load, cfg)
    new = {"volts": new_volts, "tap": new_tap, "t": local["t"] + 1}
    done = new["t"] >= cfg.horizon
    return new, _obs(new_volts, new_tap, cfg), reward, done


def ls_step(local, action, u, key, cfg: PowerGridConfig):
    """u (..., 4): influence-source bits (sampled from the AIP)."""
    ks = R.split(key, 2)
    load = _load(R.bernoulli(ks[..., 0, :], cfg.p_load, (cfg.feeder,)),
                 R.bernoulli(ks[..., 1, :], 0.5, (cfg.feeder,)))
    return ls_step_given(local, action, u, load, cfg)


def ls_obs(local, cfg: PowerGridConfig):
    return _obs(local["volts"], local["tap"], cfg)


registry.register(
    "powergrid", sys.modules[__name__], PowerGridConfig(),
    sizer=lambda cfg, side: dataclasses.replace(cfg, n_buses=side * side))
