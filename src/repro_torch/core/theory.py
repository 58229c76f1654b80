"""Executable certificates for the paper's Section-4 theory — the port of
``repro/core/theory.py`` (float64 tensors on the CPU, over the exact
tabular IALMs of ``repro_torch.core.ialm``).

* :func:`xi` — the influence-divergence term of Lemma 2.
* :func:`lemma2_certificate` — builds two IALMs differing only in their
  influence distributions, computes exact Q^π for both, and returns
  (max |Q1−Q2|, the Lemma-2 bound R̄·(H−t)(H−t+1)/2·ξ) so tests/benchmarks
  can assert lhs ≤ bound.
* :func:`theorem1_certificate` — checks the action-gap condition and
  whether the two IALMs share an optimal policy (Theorem 1: gap > 2Δ ⇒
  same π*).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import ialm as ialm_mod


def _histories(q: Dict[Tuple, torch.Tensor]):
    return list(q.keys())


def _uniform(na: int) -> torch.Tensor:
    return torch.full((na,), 1.0 / na, dtype=ialm_mod.DTYPE)


def xi(m1: ialm_mod.TabularIALM, m2: ialm_mod.TabularIALM) -> float:
    """sup over reachable histories of Σ_u |I1(u|l) − I2(u|l)| (with the
    deterministic-observation envs, P(l|h) is a point mass)."""
    # enumerate reachable histories up to horizon via m1's support ∪ m2's
    q1 = ialm_mod.q_values(m1, lambda l: _uniform(m1.na))
    q2 = ialm_mod.q_values(m2, lambda l: _uniform(m2.na))
    ls = set(_histories(q1)) | set(_histories(q2))
    return max(float((m1.influence(l) - m2.influence(l)).abs().sum())
               for l in ls)


def lemma2_certificate(T, R, horizon, influence1, influence2,
                       policy: Callable[[Tuple], torch.Tensor]):
    """Returns dict(lhs, xi, bound, holds)."""
    m1 = ialm_mod.TabularIALM(T=T, R=R, horizon=horizon, influence=influence1)
    m2 = ialm_mod.TabularIALM(T=T, R=R, horizon=horizon, influence=influence2)
    q1 = ialm_mod.q_values(m1, policy)
    q2 = ialm_mod.q_values(m2, policy)
    common = set(q1) & set(q2)
    lhs = max(float((q1[l] - q2[l]).abs().max()) for l in common)
    x = xi(m1, m2)
    rbar = float(R.abs().max())
    bound = rbar * horizon * (horizon + 1) / 2.0 * x
    return {"lhs": lhs, "xi": x, "bound": bound, "holds": lhs <= bound + 1e-9}


def theorem1_certificate(T, R, horizon, influence1, influence2):
    """Returns dict(gap, delta, same_optimal, condition_met).

    Theorem 1: if the action gap of M1 exceeds 2Δ (the max Q-difference
    between the models over all policies — here certified with the two
    greedy policies, a sound lower bound for the test), both models share
    the optimal policy.
    """
    m1 = ialm_mod.TabularIALM(T=T, R=R, horizon=horizon, influence=influence1)
    m2 = ialm_mod.TabularIALM(T=T, R=R, horizon=horizon, influence=influence2)
    pol1, q1 = ialm_mod.optimal_policy(m1)
    pol2, q2 = ialm_mod.optimal_policy(m2)

    # Δ: max |Q1^π − Q2^π| — evaluate under both greedy policies
    delta = 0.0
    for pol in (pol1, pol2):
        qa = ialm_mod.q_values(m1, pol)
        qb = ialm_mod.q_values(m2, pol)
        for l in set(qa) & set(qb):
            delta = max(delta, float((qa[l] - qb[l]).abs().max()))

    # action gap of M1 at every history with >1 action
    gap = float("inf")
    for l, q in q1.items():
        s = torch.sort(q, descending=True).values
        if len(s) > 1:
            gap = min(gap, float(s[0] - s[1]))

    same = all(int(torch.argmax(q1[l])) == int(torch.argmax(q2[l]))
               for l in set(q1) & set(q2))
    return {"gap": gap, "delta": delta, "same_optimal": same,
            "condition_met": gap > 2 * delta}


def perturbed_influence(base: Callable, eps: float, nu: int):
    """I'(u|l) = (1−eps)·I(u|l) + eps·uniform — the controlled perturbation
    used in the Lemma-2 empirical check (ξ ≤ 2·eps)."""
    def f(l):
        p = base(l)
        return (1.0 - eps) * p + eps / nu
    return f
