"""fPOSG environment interface — the port of ``repro/envs/base.py``.

An environment module exposes the same two simulator namespaces as the
reference (see that module's docstring for the full protocol), written
in torch and batched natively: every function accepts any number of
leading batch dimensions (streams, agents) on its keys and states, where
the reference is written for one env and ``vmap``'d.

Global simulator (GS)
    ``gs_init(key (..., 2), cfg) -> state``
    ``gs_step(state, actions (..., N), key, cfg) ->
        (state', obs (..., N, O), rewards (..., N), u (..., N, M), done (...))``
    ``gs_locals(state, cfg)``, ``gs_obs(state, cfg)``

Local simulator (LS) — one region
    ``ls_init(key (..., 2), cfg) -> local``
    ``ls_step(local, action (...), u (..., M), key, cfg) ->
        (local', obs (..., O), reward (...), done (...))``

plus the factored-randomness protocol (``gs_exo``, ``gs_step_given``,
``exo_locals``, ``ls_step_given``) under which replaying region i through
the LS reproduces the GS bit for bit (Definition 3), and
``boundary_influence``/``region_partition`` of the spatial decomposition.
Integer state is int64 and flags are bool; values equal the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def contiguous_partition(n_agents: int, n_blocks: int) -> np.ndarray:
    """Equal-size contiguous agent→block assignment. Raises when the agent
    axis cannot tile the blocks."""
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
    if n_agents % n_blocks:
        raise ValueError(
            f"{n_agents} agents cannot tile {n_blocks} blocks")
    return (np.arange(n_agents) // (n_agents // n_blocks)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class EnvInfo:
    """Static facts the MARL/DIALS stack needs about an env."""
    name: str
    n_agents: int
    obs_dim: int
    n_actions: int
    n_influence: int          # M: number of binary influence sources/agent
    horizon: int
    # ALSH feature size fed to the AIP (local state + last action one-hot)
    alsh_dim: int
