"""Batched env pools — the port of ``repro/core/env_pool.py``.

A pool advances S independent simulator streams with one batched step
and in-program auto-reset. The load-bearing invariant is the reference's
per-stream key discipline: stream s draws from its OWN key chain, folded
from the ABSOLUTE stream index, so its whole draw sequence depends only
on ``(key, s, t)`` and a wider pool contains every narrower pool's
streams bit for bit:

* ``base_s   = fold_in(key, s)``                 (:func:`stream_keys`)
* ``init_s   = fold_in(base_s, 0)``              (:func:`init_keys`)
* ``step_s,t = split(fold_in(base_s, t+1), n)``  (:func:`step_keys`)

The env modules are batched natively, so a pool is plain plumbing: keys
of shape (..., S, 2) give states with leading (..., S).
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# per-stream key derivation
# ---------------------------------------------------------------------------
def stream_keys(key, n_streams: int):
    """(..., S, 2) per-stream base keys ``fold_in(key, s)`` with the
    ABSOLUTE stream index s: prefix-invariant in S."""
    s = torch.arange(n_streams, device=key.device)
    return R.fold_in(key[..., None, :], s)


def init_keys(skeys):
    """Stream-init keys: step 0 of each stream's chain."""
    return R.fold_in(skeys, 0)


def step_keys(skeys, t: int, n: int):
    """``n`` per-stream key bundles for step ``t``, stacked on a leading
    axis: (n, ..., S, 2). The chain position is ``t + 1`` (0 is init)."""
    return torch.movedim(R.split(R.fold_in(skeys, t + 1), n), -2, 0)


# ---------------------------------------------------------------------------
# auto-reset selectors
# ---------------------------------------------------------------------------
def reset_where(done, fresh, current):
    """Tree-select ``fresh`` over ``current`` on done streams, with the
    done flags broadcast by RANK against each leaf."""
    def sel(f, c):
        mask = done.reshape(done.shape + (1,) * (c.ndim - done.ndim))
        return torch.where(mask, f, c)
    return tree_map(sel, fresh, current)


def zero_on_done(done, tree):
    """Zero the policy-side per-stream state (RNN hidden, previous
    action) of finished streams."""
    return reset_where(done, tree_map(torch.zeros_like, tree), tree)


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------
class GSPool:
    """S global-simulator streams advanced as one batched step."""

    def __init__(self, env_mod, env_cfg, n_streams: int):
        self.env_mod, self.env_cfg = env_mod, env_cfg
        self.n_streams = n_streams

    def init(self, skeys):
        """Fresh env states from the streams' init keys (chain step 0)."""
        return self.env_mod.gs_init(init_keys(skeys), self.env_cfg)

    def obs(self, env):
        return self.env_mod.gs_obs(env, self.env_cfg)

    def step_reset(self, env, action, k_env, k_reset):
        """One step + auto-reset. Returns (env', obs', rew, u, done) where
        ``done`` flags the streams that ended (and were reset)."""
        mod, cfg = self.env_mod, self.env_cfg
        env2, obs2, rew, u, done = mod.gs_step(env, action, k_env, cfg)
        env3 = reset_where(done, mod.gs_init(k_reset, cfg), env2)
        obs3 = reset_where(done, mod.gs_obs(env3, cfg), obs2)
        return env3, obs3, rew, u, done


class LSPool:
    """E local-simulator streams (per agent: keys (A, E, 2)) — the IALS
    rollout's pool. Influence sources ``u`` arrive from the caller."""

    def __init__(self, env_mod, env_cfg, n_streams: int):
        self.env_mod, self.env_cfg = env_mod, env_cfg
        self.n_streams = n_streams

    def init(self, skeys):
        return self.env_mod.ls_init(init_keys(skeys), self.env_cfg)

    def obs(self, locals_):
        return self.env_mod.ls_obs(locals_, self.env_cfg)

    def step_reset(self, locals_, action, u, k_env, k_reset):
        """One influence-augmented step + auto-reset. Returns
        (locals', obs', rew, done)."""
        mod, cfg = self.env_mod, self.env_cfg
        locals2, obs2, rew, done = mod.ls_step(locals_, action, u, k_env,
                                               cfg)
        locals3 = reset_where(done, mod.ls_init(k_reset, cfg), locals2)
        obs3 = reset_where(done, mod.ls_obs(locals3, cfg), obs2)
        return locals3, obs3, rew, done
