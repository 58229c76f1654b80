"""The port's tabular theory (``repro_torch.core.{ialm,theory}``):
``tests/test_theory.py``'s six checks of Lemma 1, Corollary 1, Lemma 2
and Theorem 1 restated on the port (with the same hypothesis settings,
and on fixed seeds so they run without hypothesis too), and parity with
the reference on the same ``np.random.default_rng`` systems:
``random_system`` bitwise, ``exact_influence``, ``q_values`` and both
certificates within 1e-12 (float64) with the same history keys and
boolean fields, ``optimal_policy`` with the same greedy actions, and a
tie that both break to the first maximal action."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # dev extra absent: property tests skip
    from _hypothesis_stub import given, settings, st

from repro.core import ialm as jialm
from repro.core import theory as jtheory
from repro_torch.core import ialm, theory

TOL = 1e-12
PROBES = [(0,), (1,), (0, 0, 1), (1, 1, 0), (0, 1, 1, 0, 0)]
SEEDS = [0, 1, 7, 12345, 2**31 - 1]


def _uniform_policy(na):
    return lambda l: torch.full((na,), 1.0 / na, dtype=torch.float64)


def _const_influence(nu, p=None):
    if p is None:
        p = torch.full((nu,), 1.0 / nu, dtype=torch.float64)
    return lambda l: p


# ---------------------------------------------------------------------------
# tests/test_theory.py, restated on the port
# ---------------------------------------------------------------------------
def _check_exact_influence_is_distribution(seed):
    rng = np.random.default_rng(seed)
    T1, T2, R, pi2, b0 = ialm.random_system(rng)
    infl = ialm.exact_influence(T1, T2, pi2, b0)
    for l in PROBES:
        p = infl(l)
        assert p.shape == (T1.shape[1],) and p.dtype == torch.float64
        assert bool((p >= -1e-12).all())
        assert abs(float(p.sum()) - 1.0) <= 1e-9


def _check_lemma1_same_policy_same_influence(seed):
    """Lemma 1: one joint policy induces exactly one influence — the
    filter is a deterministic function of (T1, T2, pi2, b0)."""
    rng = np.random.default_rng(seed)
    T1, T2, R, pi2, b0 = ialm.random_system(rng)
    i1 = ialm.exact_influence(T1, T2, pi2, b0)
    i2 = ialm.exact_influence(T1.clone(), T2.clone(), pi2.clone(),
                              b0.clone())
    for l in [(0,), (0, 1, 1), (1, 0, 0, 1, 1)]:
        np.testing.assert_allclose(i1(l).numpy(), i2(l).numpy(), atol=1e-12,
                                   rtol=0)


def _check_lemma2_bound_holds(seed, eps):
    """|Q_M1 - Q_M2| <= R̄ (H-t)(H-t+1)/2 · ξ for perturbed influences."""
    rng = np.random.default_rng(seed)
    T1, _, R, _, _ = ialm.random_system(rng)
    nu = T1.shape[1]
    p1 = torch.full((nu,), 1.0 / nu, dtype=torch.float64)
    p2 = p1.clone()
    p2[0] = min(1.0, float(p1[0]) + eps)
    p2 = p2 / p2.sum()
    cert = theory.lemma2_certificate(
        T1, R, horizon=4, influence1=_const_influence(nu, p1),
        influence2=_const_influence(nu, p2),
        policy=_uniform_policy(T1.shape[2]))
    assert cert["holds"], cert
    assert cert["lhs"] <= cert["bound"] + 1e-9


def _check_theorem1(seed):
    """Theorem 1's conclusion: when the action gap dominates 2Δ, the
    optimal policies of the two IALMs coincide."""
    rng = np.random.default_rng(seed)
    T1, _, R, _, _ = ialm.random_system(rng)
    nu = T1.shape[1]
    p1 = torch.full((nu,), 1.0 / nu, dtype=torch.float64)
    p2 = p1 + torch.linspace(-1e-4, 1e-4, nu, dtype=torch.float64)
    p2 = p2.abs() / p2.abs().sum()
    cert = theory.theorem1_certificate(
        T1, R, horizon=4, influence1=_const_influence(nu, p1),
        influence2=_const_influence(nu, p2))
    if cert["condition_met"]:
        assert cert["same_optimal"], cert


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_exact_influence_is_distribution(seed):
    _check_exact_influence_is_distribution(seed)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_lemma1_same_policy_same_influence(seed):
    _check_lemma1_same_policy_same_influence(seed)


def test_corollary1_transition_independence():
    """Corollary 1: if u is independent of the other agent's actions
    (T2 doesn't depend on a2 ⇒ x2 evolves autonomously), every pi2 gives
    the SAME influence distribution."""
    rng = np.random.default_rng(0)
    T1, T2, R, _, b0 = ialm.random_system(rng)
    T2 = T2[:, :, :1, :].repeat_interleave(T2.shape[2], dim=2)
    pi_a = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    pi_b = torch.tensor([[0.0, 1.0], [0.5, 0.5]], dtype=torch.float64)
    ia = ialm.exact_influence(T1, T2, pi_a, b0)
    ib = ialm.exact_influence(T1, T2, pi_b, b0)
    for l in [(0,), (1, 0, 1), (0, 1, 1, 0, 0)]:
        np.testing.assert_allclose(ia(l).numpy(), ib(l).numpy(), atol=1e-10,
                                   rtol=0)


@given(st.integers(0, 2**31 - 1), st.floats(0.0, 0.3))
@settings(max_examples=15, deadline=None)
def test_lemma2_bound_holds(seed, eps):
    _check_lemma2_bound_holds(seed, eps)


def test_lemma2_bound_tightness_zero_perturbation():
    rng = np.random.default_rng(7)
    T1, _, R, _, _ = ialm.random_system(rng)
    nu = T1.shape[1]
    cert = theory.lemma2_certificate(
        T1, R, horizon=4, influence1=_const_influence(nu),
        influence2=_const_influence(nu), policy=_uniform_policy(T1.shape[2]))
    assert cert["xi"] == pytest.approx(0.0, abs=1e-12)
    assert cert["lhs"] == pytest.approx(0.0, abs=1e-12)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_theorem1_small_perturbation_same_optimal_policy(seed):
    _check_theorem1(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_property_checks_on_fixed_seeds(seed):
    """The four property tests above on fixed seeds (they skip without
    hypothesis)."""
    _check_exact_influence_is_distribution(seed)
    _check_lemma1_same_policy_same_influence(seed)
    for eps in (0.0, 0.05, 0.3):
        _check_lemma2_bound_holds(seed, eps)
    _check_theorem1(seed)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------
def _systems(seed):
    return (jialm.random_system(np.random.default_rng(seed)),
            ialm.random_system(np.random.default_rng(seed)))


def _np_policy(na):
    return lambda l: np.full((na,), 1.0 / na)


def _assert_q_equal(jq, tq):
    assert set(jq) == set(tq)
    for l in jq:
        assert all(isinstance(x, int) for x in l), l
        np.testing.assert_allclose(tq[l].numpy(), jq[l], atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_system_and_exact_influence_match_reference(seed):
    jsys, tsys = _systems(seed)
    for j, t in zip(jsys, tsys):
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), j)
    jinf = jialm.exact_influence(*[jsys[i] for i in (0, 1, 3, 4)])
    tinf = ialm.exact_influence(*[tsys[i] for i in (0, 1, 3, 4)])
    for l in PROBES + [(0, 1, 1), (1, 0, 0, 1, 1)]:
        np.testing.assert_allclose(tinf(l).numpy(), jinf(l), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_q_values_and_optimal_policy_match_reference(seed):
    (jT1, jT2, jR, jpi2, jb0), (T1, T2, R, pi2, b0) = _systems(seed)
    jm = jialm.TabularIALM(T=jT1, R=jR, horizon=4,
                           influence=jialm.exact_influence(jT1, jT2, jpi2,
                                                           jb0))
    tm = ialm.TabularIALM(T=T1, R=R, horizon=4,
                          influence=ialm.exact_influence(T1, T2, pi2, b0))
    _assert_q_equal(jialm.q_values(jm, _np_policy(2)),
                    ialm.q_values(tm, _uniform_policy(2)))
    jpol, jq = jialm.optimal_policy(jm)
    tpol, tq = ialm.optimal_policy(tm)
    _assert_q_equal(jq, tq)
    for l in jq:
        np.testing.assert_array_equal(tpol(l).numpy(), jpol(l))


@pytest.mark.parametrize("seed", SEEDS)
def test_certificates_match_reference(seed):
    (jT1, jT2, jR, jpi2, jb0), (T1, T2, R, pi2, b0) = _systems(seed)
    jbase = jialm.exact_influence(jT1, jT2, jpi2, jb0)
    tbase = ialm.exact_influence(T1, T2, pi2, b0)
    for eps in (0.0, 0.05, 0.4):
        jc = jtheory.lemma2_certificate(
            jT1, jR, 4, jbase, jtheory.perturbed_influence(jbase, eps, 2),
            _np_policy(2))
        tc = theory.lemma2_certificate(
            T1, R, 4, tbase, theory.perturbed_influence(tbase, eps, 2),
            _uniform_policy(2))
        for k in ("lhs", "xi", "bound"):
            assert abs(tc[k] - jc[k]) <= TOL, (k, eps, tc[k], jc[k])
        assert tc["holds"] is bool(jc["holds"])
    # Theorem 1 between the exact influence and a perturbed one
    jc = jtheory.theorem1_certificate(
        jT1, jR, 4, jbase, jtheory.perturbed_influence(jbase, 0.01, 2))
    tc = theory.theorem1_certificate(
        T1, R, 4, tbase, theory.perturbed_influence(tbase, 0.01, 2))
    for k in ("gap", "delta"):
        assert abs(tc[k] - jc[k]) <= TOL, (k, tc[k], jc[k])
    for k in ("same_optimal", "condition_met"):
        assert tc[k] is bool(jc[k]), k


def test_argmax_tie_goes_to_the_first_action():
    """Rewards that do not depend on the action tie every Q row; both
    packages' greedy policies then take action 0, and the gap is 0."""
    nx, nu, na = 2, 2, 3
    T = np.full((nx, nu, na, nx), 1.0 / nx)
    R = np.array([[0.5] * na, [1.0] * na])
    jm = jialm.TabularIALM(T=T, R=R, horizon=3,
                           influence=lambda l: np.full((nu,), 1.0 / nu))
    tm = ialm.TabularIALM(
        T=torch.from_numpy(T), R=torch.from_numpy(R), horizon=3,
        influence=lambda l: torch.full((nu,), 1.0 / nu,
                                       dtype=torch.float64))
    jpol, jq = jialm.optimal_policy(jm)
    tpol, tq = ialm.optimal_policy(tm)
    _assert_q_equal(jq, tq)
    for l in jq:
        assert len(set(tq[l].tolist())) == 1          # a true tie
        np.testing.assert_array_equal(tpol(l).numpy(), jpol(l))
        assert tpol(l).tolist() == [1.0, 0.0, 0.0]
    cert = theory.theorem1_certificate(tm.T, tm.R, 3, tm.influence,
                                       tm.influence)
    assert cert["gap"] == 0.0 and cert["delta"] == 0.0
    assert cert["same_optimal"] and not cert["condition_met"]
    # the pruning: a zero-probability successor is never expanded
    T0 = np.zeros((nx, nu, na, nx))
    T0[..., 0] = 1.0
    q = ialm.q_values(ialm.TabularIALM(
        T=torch.from_numpy(T0), R=torch.from_numpy(R), horizon=3,
        influence=tm.influence), _uniform_policy(na))
    assert all(l[2::2] == (0,) * len(l[2::2]) for l in q)
    assert set(q) == set(jialm.q_values(jialm.TabularIALM(
        T=T0, R=R, horizon=3, influence=jm.influence), _np_policy(na)))
    assert len(q) == 2 + 2 * na + 2 * na * na
