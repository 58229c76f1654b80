"""Tabular IALM machinery (Definition 3 / Eq. 1), exact and enumerative —
the port of ``repro/core/ialm.py``.

Used by the theory layer (``repro_torch.core.theory``) and
``benchmarks/torch_run.py``'s ``table_lemma2`` to check the paper's
formal claims on small instances where everything is computable exactly:

* :func:`q_values` — finite-horizon Q over action-local-state histories
  for an IALM with an arbitrary influence distribution I(u | l).
* :func:`exact_influence` — the TRUE influence of a 2-region coupled
  system (each region's influence source is the other region's state),
  computed by HMM filtering: Lemma 1's "joint policy ⇒ unique influence"
  made executable.

Everything is float64 on the CPU: the tables are a few dozen numbers and
the recursion branches in Python. Histories are tuples of ints
⟨x0, a0, x1, ..., xt⟩ (observations are the local state itself, as in
both paper envs' local views), the keys of the Q dicts.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

DTYPE = torch.float64


@dataclasses.dataclass(frozen=True)
class TabularIALM:
    """T: (nx, nu, na, nx) local transition; R: (nx, na); horizon H.
    influence: history tuple -> (nu,) probabilities. Tensors, float64."""
    T: torch.Tensor
    R: torch.Tensor
    horizon: int
    influence: Callable[[Tuple], torch.Tensor]

    @property
    def nx(self):
        return self.T.shape[0]

    @property
    def nu(self):
        return self.T.shape[1]

    @property
    def na(self):
        return self.T.shape[2]


def q_values(m: TabularIALM, policy: Callable[[Tuple], torch.Tensor]
             ) -> Dict[Tuple, torch.Tensor]:
    """Exact Q^π(l, ·) for every reachable history, by backward recursion
    on the IALM dynamics P(x'|l,a) = Σ_u T(x'|x,u,a) I(u|l) (Eq. 1)."""
    q: Dict[Tuple, torch.Tensor] = {}

    def recurse(l: Tuple, t: int) -> torch.Tensor:
        if l in q:
            return q[l]
        x = l[-1]
        vals = m.R[x].to(DTYPE, copy=True)
        if t < m.horizon - 1:
            iu = m.influence(l)                       # (nu,)
            for a in range(m.na):
                px = torch.einsum("u,ux->x", iu, m.T[x, :, a, :])
                for x2 in range(m.nx):
                    if px[x2] <= 0:
                        continue
                    l2 = l + (a, x2)
                    q2 = recurse(l2, t + 1)
                    vals[a] += px[x2] * torch.dot(policy(l2), q2)
        q[l] = vals
        return vals

    for x0 in range(m.nx):
        recurse((x0,), 0)
    return q


def optimal_policy(m: TabularIALM):
    """Greedy backward induction; returns (policy_fn, q_star dict). A tie
    goes to the first maximal action, as ``np.argmax``'s does."""
    qstar: Dict[Tuple, torch.Tensor] = {}

    def recurse(l: Tuple, t: int) -> torch.Tensor:
        if l in qstar:
            return qstar[l]
        x = l[-1]
        vals = m.R[x].to(DTYPE, copy=True)
        if t < m.horizon - 1:
            iu = m.influence(l)
            for a in range(m.na):
                px = torch.einsum("u,ux->x", iu, m.T[x, :, a, :])
                for x2 in range(m.nx):
                    if px[x2] <= 0:
                        continue
                    vals[a] += px[x2] * torch.max(recurse(l + (a, x2),
                                                          t + 1))
        qstar[l] = vals
        return vals

    for x0 in range(m.nx):
        recurse((x0,), 0)

    def pol(l):
        p = torch.zeros(m.na, dtype=DTYPE)
        p[torch.argmax(qstar[l])] = 1.0
        return p

    return pol, qstar


# ---------------------------------------------------------------------------
# Exact influence for a symmetric 2-region coupled system
# ---------------------------------------------------------------------------
def exact_influence(T1: torch.Tensor, T2: torch.Tensor,
                    pi2: torch.Tensor, b0: torch.Tensor):
    """True I_1(u | l_1) where u = region 2's state.

    T1: (x1, u, a1, x1') — region 1's local transition (u = x2).
    T2: (x2, u2, a2, x2') — region 2's, with u2 = x1 (mutual coupling).
    pi2: (x2, a2) — agent 2's (memoryless) policy.
    b0: (nx2,) initial distribution over x2.

    Returns influence(l) -> (nu,) — an HMM filter over x2: each observed
    region-1 transition re-weights the belief by its likelihood under u,
    then the belief propagates through region 2's dynamics.
    """
    @functools.lru_cache(maxsize=None)
    def belief(l: Tuple) -> torch.Tensor:
        if len(l) == 1:
            return b0
        *prev, a1, x1_new = l
        lp = tuple(prev)
        b = belief(lp)                               # P(x2_t | l_t)
        x1_old = lp[-1]
        # evidence: the observed region-1 transition
        lik = T1[x1_old, :, a1, x1_new]              # (nu,) = (nx2,)
        b = b * lik
        s = b.sum()
        b = b / s if s > 0 else torch.full_like(b, 1.0 / len(b))
        # propagate region 2 one step (its influence source was x1_old)
        return torch.einsum("x,xa,xay->y", b, pi2, T2[:, x1_old, :, :])

    return lambda l: belief(tuple(l))


def random_system(rng: np.random.Generator, nx=2, na=2):
    """A random symmetric 2-region coupled system for property tests:
    the reference's draws from ``rng``, in its order, as float64
    tensors (the arrays are the reference's bit for bit)."""
    def rand_t():
        t = rng.random((nx, nx, na, nx)) + 0.1
        return t / t.sum(-1, keepdims=True)
    T1, T2 = rand_t(), rand_t()
    R = rng.random((nx, na))
    pi2 = rng.random((nx, na)) + 0.1
    pi2 = pi2 / pi2.sum(-1, keepdims=True)
    b0 = np.full((nx,), 1.0 / nx)
    return tuple(torch.from_numpy(a) for a in (T1, T2, R, pi2, b0))
