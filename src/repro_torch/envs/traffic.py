"""Traffic-light control env — the port of ``repro/envs/traffic.py``.

A n×n grid of intersections; each has 4 incoming lanes of L cells
(cellular-automaton traffic: a car advances iff the next cell is free;
the head car crosses iff its lane has green). A car that crosses
continues straight into the matching incoming lane of the neighbouring
intersection: this hand-off is the only coupling, so agent (i, j)'s
influence sources are the 4 bits "a car enters lane l this step".

Lanes are ordered [N, E, S, W] (the direction a car comes FROM). Phase
0 = green for N/S, 1 = green for E/W; action 1 toggles the phase. Reward
= the fraction of local cars that moved this step.

Every function takes any leading batch dimensions on its keys and
states (the reference is written for one env and vmapped; its
per-intersection ``vmap`` of :func:`lane_step` is a batch over the
trailing (n, n) here). :func:`lane_step` is shared verbatim between GS
and LS, so the LS replays the GS exactly (Definition 3).
``region_partition`` and ``boundary_influence`` (the sharded GS's) are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from repro_torch import random as R
from repro_torch.envs import registry
from repro_torch.envs.base import EnvInfo


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n: int = 2                  # grid side; N = n*n agents
    lane_len: int = 8           # L
    p_in: float = 0.3           # boundary car-injection probability
    horizon: int = 100
    init_density: float = 0.2

    @property
    def n_agents(self) -> int:
        return self.n * self.n

    def info(self) -> EnvInfo:
        obs_dim = 4 * self.lane_len + 2
        return EnvInfo(name="traffic", n_agents=self.n_agents,
                       obs_dim=obs_dim, n_actions=2, n_influence=4,
                       horizon=self.horizon,
                       alsh_dim=obs_dim + 2)


# ---------------------------------------------------------------------------
# Shared per-intersection transition (the \dot{T}_i of the IALM)
# ---------------------------------------------------------------------------
def lane_step(lanes, green, inflow):
    """Intersections' lanes for one step, batched over leading dims.

    lanes (..., 4, L) bool: cell 0 is the region entry, cell L-1 the stop
    line; green (..., 4) bool: may the head car cross; inflow (..., 4)
    bool: does a car enter cell 0 (the influence sources).

    Returns (new_lanes, out (..., 4) crossed cars, moved (...),
    count (...)), the last two float32.
    """
    lanes = lanes.bool()
    ahead_free = torch.cat([~lanes[..., 1:], green[..., None].bool()],
                           dim=-1)
    move = lanes & ahead_free
    shifted = torch.cat([torch.zeros_like(move[..., :1]), move[..., :-1]],
                        dim=-1)
    new = (lanes & ~move) | shifted
    out = move[..., -1]
    # inflow enters cell 0 if it is free after the shift
    enter = inflow.bool() & ~new[..., 0]
    new = torch.cat([(new[..., 0] | enter)[..., None], new[..., 1:]], dim=-1)
    moved = move.sum((-2, -1))         # mean-speed proxy over pre-step cars
    count = lanes.sum((-2, -1))
    return new, out, moved.float(), count.float()


def _green(phase):
    """phase (...) int -> (..., 4) bool for lanes [N, E, S, W]."""
    ns = phase == 0
    return torch.stack([ns, ~ns, ns, ~ns], dim=-1)


def _obs(lanes, phase):
    """lanes (..., 4, L), phase (...) -> (..., 4L + 2)."""
    return torch.cat([
        lanes.reshape(lanes.shape[:-2] + (-1,)).float(),
        torch.nn.functional.one_hot(phase, 2).float()], dim=-1)


def _reward(moved, count):
    return moved / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# Global simulator
# ---------------------------------------------------------------------------
def gs_init(key, cfg: TrafficConfig):
    ks = R.split(key, 2)
    lanes = R.bernoulli(ks[..., 0, :], cfg.init_density,
                        (cfg.n, cfg.n, 4, cfg.lane_len))
    phase = R.randint(ks[..., 1, :], (cfg.n, cfg.n), 0, 2)
    return {"lanes": lanes, "phase": phase,
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def gs_inflow(out, inject, cfg: TrafficConfig):
    """Wire crossed cars into neighbours. out, inject: (..., n, n, 4);
    rows are axis -3 and columns axis -2, which indexing the lane leaves
    as axes -2 and -1."""
    del cfg
    # lane 0 (from N, heading S): inflow[i] = out[i-1]; row 0 injected
    in_n = torch.cat([inject[..., :1, :, 0], out[..., :-1, :, 0]], dim=-2)
    # lane 2 (from S, heading N): inflow[i] = out[i+1]; row n-1 injected
    in_s = torch.cat([out[..., 1:, :, 2], inject[..., -1:, :, 2]], dim=-2)
    # lane 1 (from E, heading W): inflow[:, j] = out[:, j+1]; col n-1
    # injected
    in_e = torch.cat([out[..., :, 1:, 1], inject[..., :, -1:, 1]], dim=-1)
    # lane 3 (from W, heading E): inflow[:, j] = out[:, j-1]; col 0 injected
    in_w = torch.cat([inject[..., :, :1, 3], out[..., :, :-1, 3]], dim=-1)
    return torch.stack([in_n, in_e, in_s, in_w], dim=-1)       # (..., n, n, 4)


def gs_step_given(state, actions, inject, cfg: TrafficConfig):
    """Deterministic GS step given boundary-injection bits (..., n, n, 4)."""
    n = cfg.n
    batch = actions.shape[:-1]
    phase = (state["phase"] + actions.reshape(batch + (n, n))) % 2
    green = _green(phase)                                      # (..., n, n, 4)

    lanes = state["lanes"]
    # who crosses: the out bits depend only on the pre-step state
    out = lanes[..., -1] & green                               # (..., n, n, 4)
    inflow = gs_inflow(out, inject, cfg)
    new_lanes, _, moved, count = lane_step(lanes, green, inflow)

    rewards = _reward(moved, count).reshape(batch + (cfg.n_agents,))
    obs = _obs(new_lanes, phase).reshape(batch + (cfg.n_agents, -1))
    u = inflow.reshape(batch + (cfg.n_agents, 4)).float()
    new_state = {"lanes": new_lanes, "phase": phase, "t": state["t"] + 1}
    done = new_state["t"] >= cfg.horizon
    return new_state, obs, rewards, u, done


def gs_exo(key, cfg: TrafficConfig):
    """Exogenous draws: boundary car-injection bits (..., n, n, 4)."""
    return R.bernoulli(key, cfg.p_in, (cfg.n, cfg.n, 4))


def exo_locals(inject, cfg: TrafficConfig):
    """Per-region restriction of the exogenous draws. Boundary injection
    reaches a region only through its inflow u, so the LS transition
    takes no direct exogenous input: (..., N, 0)."""
    return torch.zeros(inject.shape[:-3] + (cfg.n_agents, 0),
                       device=inject.device)


def gs_step(state, actions, key, cfg: TrafficConfig):
    return gs_step_given(state, actions, gs_exo(key, cfg), cfg)


def gs_obs(state, cfg: TrafficConfig):
    phase = state["phase"]
    return _obs(state["lanes"], phase).reshape(
        phase.shape[:-2] + (cfg.n_agents, -1))


def gs_locals(state, cfg: TrafficConfig):
    """Per-agent local states (..., N, ...) for dataset collection."""
    batch = state["phase"].shape[:-2]
    return {"lanes": state["lanes"].reshape(
                batch + (cfg.n_agents, 4, cfg.lane_len)),
            "phase": state["phase"].reshape(batch + (cfg.n_agents,))}


# ---------------------------------------------------------------------------
# Local simulator (one intersection; inflow driven by the AIP)
# ---------------------------------------------------------------------------
def ls_init(key, cfg: TrafficConfig):
    ks = R.split(key, 2)
    return {"lanes": R.bernoulli(ks[..., 0, :], cfg.init_density,
                                 (4, cfg.lane_len)),
            "phase": R.randint(ks[..., 1, :], (), 0, 2),
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def ls_step_given(local, action, u, exo, cfg: TrafficConfig):
    """Uniform-protocol alias: the traffic LS takes no direct exogenous
    input (``exo`` is the empty per-region restriction)."""
    del exo
    return ls_step(local, action, u, None, cfg)


def ls_step(local, action, u, key, cfg: TrafficConfig):
    """u (..., 4): influence-source bits (sampled from the AIP)."""
    del key
    phase = (local["phase"] + action) % 2
    new_lanes, _, moved, count = lane_step(local["lanes"], _green(phase),
                                           u.bool())
    new = {"lanes": new_lanes, "phase": phase, "t": local["t"] + 1}
    done = new["t"] >= cfg.horizon
    return new, _obs(new_lanes, phase), _reward(moved, count), done


def ls_obs(local, cfg: TrafficConfig):
    return _obs(local["lanes"], local["phase"])


registry.register(
    "traffic", sys.modules[__name__], TrafficConfig(),
    sizer=lambda cfg, side: dataclasses.replace(cfg, n=side))
