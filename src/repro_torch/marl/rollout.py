"""Generic rollout: a loop over time of (policy step → env step),
parameterized by a closure — the port of ``repro/marl/rollout.py``
(its ``lax.scan`` is a Python loop over the keys' leading axis here).

Nothing on the DIALS path calls it, in the reference as in the port:
``core/gs.py``, ``core/ials.py`` and ``marl/runner.py`` roll their own
loops. It is here for completeness.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Transition(NamedTuple):
    obs: torch.Tensor          # (..., O) observation BEFORE the step
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor         # episode ended at this step
    h_pre: torch.Tensor        # policy hidden BEFORE the step


def rollout(carry0, steps: int, step_fn: Callable):
    """carry0: (rollout state, keys (T, 2)); step_fn(carry, key) ->
    (carry, Transition). Returns (carry, traj) with traj leaves
    (T, ...), each step's leaf stacked on a new leading time axis.
    ``steps`` is the keys' length, as in the reference (unused)."""
    carry, keys = carry0
    traj = []
    for key in keys:
        carry, step = step_fn(carry, key)
        traj.append(step)
    return carry, tree_map(lambda *xs: torch.stack(xs), traj[0], *traj[1:])


def time_major_to_env_major(traj):
    """(T, E, ...) -> (E, T, ...)."""
    return tree_map(lambda x: x.swapaxes(0, 1), traj)
