"""Warehouse commissioning env — the port of ``repro/envs/warehouse.py``.

k×k robots, each confined to a 5×5 region with spacing 4, so each of the
four 3-cell item shelves on a region's edges is shared with the adjacent
region. Items appear with p=0.02 on empty shelf cells and age by 1 per
step; a robot collects the item under it and earns age/max_region_age.
Agent i's influence sources are the 12 binary "another robot sits on my
item cell c" variables.

Every function takes any leading batch dimensions on its keys and states
(the reference is written for one env and vmapped). The per-region
transition :func:`region_step` is shared verbatim between GS and LS, so
the LS replays the GS exactly (Definition 3).
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.envs import registry
from repro_torch.envs.base import EnvInfo, contiguous_partition


@dataclasses.dataclass(frozen=True)
class WarehouseConfig:
    k: int = 2                   # k*k robots
    p_item: float = 0.02
    horizon: int = 100

    @property
    def n_agents(self) -> int:
        return self.k * self.k

    @property
    def grid(self) -> int:       # global grid side
        return 4 * self.k + 1

    def info(self) -> EnvInfo:
        obs_dim = 25 + 12
        return EnvInfo(name="warehouse", n_agents=self.n_agents,
                       obs_dim=obs_dim, n_actions=5, n_influence=12,
                       horizon=self.horizon, alsh_dim=obs_dim + 5)


def item_cells(cfg: WarehouseConfig) -> np.ndarray:
    """(N, 12, 2) absolute coords of each region's item cells.
    Order: north shelf (3), east (3), south (3), west (3)."""
    cells = np.zeros((cfg.n_agents, 12, 2), np.int64)
    for i in range(cfg.k):
        for j in range(cfg.k):
            r0, c0 = 4 * i, 4 * j
            cs = ([(r0, c0 + d) for d in (1, 2, 3)] +          # north
                  [(r0 + d, c0 + 4) for d in (1, 2, 3)] +      # east
                  [(r0 + 4, c0 + d) for d in (1, 2, 3)] +      # south
                  [(r0 + d, c0) for d in (1, 2, 3)])           # west
            cells[i * cfg.k + j] = np.array(cs, np.int64)
    return cells


def region_origin(cfg: WarehouseConfig) -> np.ndarray:
    """(N, 2) top-left corner of each region."""
    out = np.zeros((cfg.n_agents, 2), np.int64)
    for i in range(cfg.k):
        for j in range(cfg.k):
            out[i * cfg.k + j] = (4 * i, 4 * j)
    return out


_MOVES = [[0, 0], [-1, 0], [0, 1], [1, 0], [0, -1]]
# local coords of the 12 item cells (same for every region)
_LOCAL_CELLS = [[0, 1], [0, 2], [0, 3], [1, 4], [2, 4], [3, 4],
                [4, 1], [4, 2], [4, 3], [1, 0], [2, 0], [3, 0]]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(moves, local item cells) on ``device``, built once: a table copied
    from the host at every step would be a host-device copy per step."""
    return (torch.tensor(_MOVES, device=device),
            torch.tensor(_LOCAL_CELLS, device=device))


@functools.lru_cache(maxsize=None)
def _consts(cfg: WarehouseConfig, device: torch.device):
    """Device-resident constant tables, built once per (cfg, device)."""
    cells = torch.as_tensor(item_cells(cfg), device=device)
    g = cfg.grid
    shelf = torch.zeros((g, g), dtype=torch.bool, device=device)
    shelf[cells[..., 0].reshape(-1), cells[..., 1].reshape(-1)] = True
    return {"cells": cells,
            "origin": torch.as_tensor(region_origin(cfg), device=device),
            "shelf": shelf,
            "moves": _tables(device)[0],
            "not_own": ~torch.eye(cfg.n_agents, dtype=torch.bool,
                                  device=device)[:, None, :]}


def _move(pos, action, moves):
    return torch.clamp(pos + moves[action], 0, 4)


# ---------------------------------------------------------------------------
# Shared per-region transition (the \dot{T}_i of the IALM)
# ---------------------------------------------------------------------------
def region_step(pos, ages, action, u, spawn):
    """One region for one step, in LOCAL coordinates, batched over leading
    dims. pos (..., 2) in [0,4]²; ages (..., 12) item ages (0 = empty);
    action (...) in [0,5); u (..., 12) another robot on item cell c;
    spawn (..., 12) item-appearance draws.

    Returns (new_pos, new_ages, reward, on_item (..., 12) self-occupancy).
    """
    moves, local_cells = _tables(pos.device)
    new_pos = _move(pos, action, moves)
    on_item = (local_cells == new_pos[..., None, :]).all(-1)   # (..., 12)

    active = ages > 0
    max_age = torch.clamp(ages.max(-1).values, min=1).float()
    collected_self = on_item & active
    reward = torch.where(collected_self, ages.float() / max_age[..., None],
                         0.0).sum(-1)

    removed = active & (on_item | u.bool())
    ages = torch.where(removed, 0, ages)
    ages = torch.where(ages > 0, ages + 1, ages)                # age
    ages = torch.where((ages == 0) & spawn.bool(), 1, ages)     # spawn
    return new_pos, ages, reward, on_item


def _obs(pos, ages):
    pos_oh = torch.nn.functional.one_hot(pos[..., 0] * 5 + pos[..., 1], 25)
    return torch.cat([pos_oh.float(), (ages > 0).float()], dim=-1)


# ---------------------------------------------------------------------------
# Global simulator
# ---------------------------------------------------------------------------
def gs_init(key, cfg: WarehouseConfig):
    c = _consts(cfg, key.device)
    ks = R.split(key, 2)
    pos = R.randint(ks[..., 0, :], (cfg.n_agents, 2), 0, 5)     # local coords
    g = cfg.grid
    spawn0 = R.bernoulli(ks[..., 1, :], 0.2, (g, g))
    ages = (c["shelf"] & spawn0).long()
    return {"pos": pos, "ages": ages,
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def gs_influence(pos, cfg: WarehouseConfig):
    """u (..., N, 12): another robot sits on region i's item cell c,
    from CURRENT (post-move) local positions."""
    c = _consts(cfg, pos.device)
    ap = pos + c["origin"]                                      # (..., N, 2)
    same = (c["cells"][:, :, None, :] ==
            ap[..., None, None, :, :]).all(-1)                  # (..., N,12,N)
    return (same & c["not_own"]).any(-1)


def _region_view(grid, cfg):
    """(..., G, G) -> (..., N, 12): each region's item cells."""
    cells = _consts(cfg, grid.device)["cells"]
    return grid[..., cells[..., 0], cells[..., 1]]


def gs_step_given(state, actions, spawn_grid, cfg: WarehouseConfig):
    """spawn_grid: (..., G, G) bool item-appearance draws."""
    c = _consts(cfg, actions.device)
    # 1. all robots move globally first: the influence bits every region
    #    agrees on come from the post-move positions
    u = gs_influence(_move(state["pos"], actions, c["moves"]), cfg)

    # 2. per-region transitions on region-local views of the item grid
    rp, ra, rewards, _ = region_step(
        state["pos"], _region_view(state["ages"], cfg), actions, u,
        _region_view(spawn_grid, cfg))

    # 3. write back: shared cells receive identical values from both
    #    owners (same u/spawn/ages inputs), so scatter order is irrelevant
    ages = state["ages"].clone()
    ages[..., c["cells"][..., 0].reshape(-1), c["cells"][..., 1].reshape(-1)] \
        = ra.reshape(ra.shape[:-2] + (-1,))

    new_state = {"pos": rp, "ages": ages, "t": state["t"] + 1}
    done = new_state["t"] >= cfg.horizon
    return new_state, _obs(rp, ra), rewards, u.float(), done


def gs_exo(key, cfg: WarehouseConfig):
    """Exogenous draws: item-appearance bits on the global grid (G, G)."""
    g = cfg.grid
    return R.bernoulli(key, cfg.p_item, (g, g))


def exo_locals(spawn_grid, cfg: WarehouseConfig):
    """Per-region restriction: each region's 12 item-cell spawn bits."""
    return _region_view(spawn_grid, cfg)


def region_partition(cfg: WarehouseConfig, n_blocks: int):
    """Contiguous row bands of the k×k region grid: ``n_blocks`` must
    divide k."""
    if cfg.k % n_blocks:
        raise ValueError(
            f"warehouse region grid side {cfg.k} cannot split into "
            f"{n_blocks} row bands")
    return contiguous_partition(cfg.n_agents, n_blocks)


def boundary_influence(states, actions, spawn_grid, cfg: WarehouseConfig):
    """Agent-major restatement of the occupancy influence: u (..., N, 12)
    from post-move absolute positions."""
    del spawn_grid
    moves = _consts(cfg, actions.device)["moves"]
    return gs_influence(_move(states["pos"], actions, moves), cfg).float()


def gs_step(state, actions, key, cfg: WarehouseConfig):
    return gs_step_given(state, actions, gs_exo(key, cfg), cfg)


def gs_obs(state, cfg: WarehouseConfig):
    return _obs(state["pos"], _region_view(state["ages"], cfg))


def gs_locals(state, cfg: WarehouseConfig):
    return {"pos": state["pos"], "ages": _region_view(state["ages"], cfg)}


# ---------------------------------------------------------------------------
# Local simulator
# ---------------------------------------------------------------------------
def ls_init(key, cfg: WarehouseConfig):
    ks = R.split(key, 2)
    return {"pos": R.randint(ks[..., 0, :], (2,), 0, 5),
            "ages": R.bernoulli(ks[..., 1, :], 0.2, (12,)).long(),
            "t": torch.zeros(key.shape[:-1], dtype=torch.int64,
                             device=key.device)}


def ls_step(local, action, u, key, cfg: WarehouseConfig):
    spawn = R.bernoulli(key, cfg.p_item, (12,))
    return ls_step_given(local, action, u, spawn, cfg)


def ls_step_given(local, action, u, spawn, cfg: WarehouseConfig):
    pos, ages, reward, _ = region_step(local["pos"], local["ages"],
                                       action, u, spawn)
    new = {"pos": pos, "ages": ages, "t": local["t"] + 1}
    done = new["t"] >= cfg.horizon
    return new, _obs(pos, ages), reward, done


def ls_obs(local, cfg: WarehouseConfig):
    return _obs(local["pos"], local["ages"])


registry.register(
    "warehouse", sys.modules[__name__], WarehouseConfig(),
    sizer=lambda cfg, side: dataclasses.replace(cfg, k=side))
