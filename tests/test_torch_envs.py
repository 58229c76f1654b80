"""The port's four envs (``repro_torch.envs``) against the reference:
bitwise from the same key (inits, exogenous draws) and from the same
exogenous draws (steps, influence), plus Definition-3 GS<->LS exactness
run on the port itself. Every case runs for each env; warehouse's cases
keep their ids."""
import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_tree_equal, jkey_to_torch, to_torch
from repro.envs import registry as jreg
from repro_torch import random as R
from repro_torch.envs import registry


ENVS = ("warehouse", "traffic", "powergrid", "supplychain")


def _cases():
    """Warehouse at sides 2 and 3 under its original ids; the other envs
    at side 3, whose grid or line has interior regions as well as edges
    (the JAX compiles dominate these tests' time)."""
    return [pytest.param(env, side,
                         id=str(side) if env == "warehouse"
                         else f"{env}-{side}")
            for env in ENVS
            for side in ((2, 3) if env == "warehouse" else (3,))]


def _pair(env, side, horizon=20):
    jmod, jcfg = jreg.make(env, side=side, horizon=horizon)
    mod, cfg = registry.make(env, side=side, horizon=horizon)
    return jmod, jcfg, mod, cfg


def test_registry_resolves_warehouse():
    assert registry.names() == jreg.names()
    assert sorted(ENVS) == registry.names()
    mod, cfg = registry.make("warehouse", side=10)
    assert cfg.n_agents == 100
    for env in ENVS:
        assert vars(registry.make(env, side=10)[1].info()) == \
            vars(jreg.make(env, side=10)[1].info()), env
    with pytest.raises(KeyError):
        registry.get("no-such-env")
    jcfg = jreg.make("warehouse", side=4)[1]
    for blocks in (1, 2, 4):
        np.testing.assert_array_equal(
            mod.region_partition(registry.make("warehouse", side=4)[1],
                                 blocks),
            jreg.get("warehouse").module.region_partition(jcfg, blocks))
    with pytest.raises(ValueError):
        mod.region_partition(cfg, 3)


@pytest.mark.parametrize("env,side", _cases())
def test_inits_and_exo_bitwise_from_same_key(env, side):
    jmod, jcfg, mod, cfg = _pair(env, side)
    # batched keys: one env per key, as the reference's vmap
    ks = jax.random.split(jax.random.PRNGKey(9), 6)
    tks = jkey_to_torch(ks)
    for name in ("gs_init", "ls_init", "gs_exo"):
        jfn = jax.jit(jax.vmap(lambda k: getattr(jmod, name)(k, jcfg)))
        assert_tree_equal(jfn(ks), getattr(mod, name)(tks, cfg))
    k = jax.random.PRNGKey(3)
    assert_tree_equal(jax.jit(lambda k: jmod.gs_init(k, jcfg))(k),
                      mod.gs_init(R.key(3), cfg))


@pytest.mark.parametrize("env,side", _cases())
def test_steps_bitwise_from_same_exo(env, side):
    """gs_step_given, ls_step_given, exo_locals, gs_obs and gs_locals
    from the same state, actions and exo (and boundary_influence where
    the port has it: warehouse)."""
    jmod, jcfg, mod, cfg = _pair(env, side, horizon=12)
    n, info = cfg.n_agents, cfg.info()
    boundary = hasattr(mod, "boundary_influence")
    j = {name: jax.jit(lambda *a, f=getattr(jmod, name): f(*a, jcfg))
         for name in ("exo_locals", "boundary_influence", "gs_step_given",
                      "gs_obs", "gs_locals", "ls_step_given")}
    key = jax.random.PRNGKey(1)
    jstate = jmod.gs_init(key, jcfg)
    state = to_torch(jstate)
    jlocal = jmod.ls_init(key, jcfg)
    local = to_torch(jlocal)
    for t in range(14):
        key, ka, kx, ku = jax.random.split(key, 4)
        actions = jax.random.randint(ka, (n,), 0, info.n_actions)
        exo = jmod.gs_exo(kx, jcfg)
        ta, texo = to_torch(actions), to_torch(exo)
        assert_tree_equal(j['exo_locals'](exo),
                          mod.exo_locals(texo, cfg))
        if boundary:
            assert_tree_equal(
                j['boundary_influence'](j['gs_locals'](jstate), actions,
                                        exo),
                mod.boundary_influence(mod.gs_locals(state, cfg), ta, texo,
                                       cfg))
        jout = j['gs_step_given'](jstate, actions, exo)
        out = mod.gs_step_given(state, ta, texo, cfg)
        assert_tree_equal(jout, out)
        jstate, state = jout[0], out[0]
        assert_tree_equal(j['gs_obs'](jstate), mod.gs_obs(state, cfg))
        assert_tree_equal(j['gs_locals'](jstate),
                          mod.gs_locals(state, cfg))
        u = jax.random.bernoulli(ku, 0.3, (info.n_influence,))
        spawn = j['exo_locals'](exo)[0]
        jl = j['ls_step_given'](jlocal, actions[0], u, spawn)
        tl = mod.ls_step_given(local, ta[0], to_torch(u), to_torch(spawn),
                               cfg)
        assert_tree_equal(jl, tl)
        jlocal, local = jl[0], tl[0]


@pytest.mark.parametrize("env,side", _cases())
def test_port_gs_ls_exactness(env, side):
    """Definition 3 on the port: replaying each region's GS trajectory
    through the port's LS with the same (action, u, exo) reproduces the
    GS's local states and rewards (tests/test_registry.py's check)."""
    mod, cfg = registry.make(env, side=side, horizon=50)
    n = cfg.n_agents
    key = R.key(1)
    state = mod.gs_init(key, cfg)
    for t in range(15):
        ks = R.split(key, 3)
        key = ks[0]
        actions = R.randint(ks[1], (n,), 0, cfg.info().n_actions)
        exo = mod.gs_exo(ks[2], cfg)
        loc_before = mod.gs_locals(state, cfg)
        state2, _, rew, u, _ = mod.gs_step_given(state, actions, exo, cfg)
        loc_after = mod.gs_locals(state2, cfg)
        exo_loc = mod.exo_locals(exo, cfg)
        local = {**{k: v for k, v in loc_before.items()},
                 "t": state["t"].expand(n)}
        new, _, r, _ = mod.ls_step_given(local, actions, u, exo_loc, cfg)
        for k in loc_after:
            assert torch.equal(new[k], loc_after[k]), (k, t)
        np.testing.assert_allclose(r.numpy(), rew.numpy(), atol=1e-6)
        state = state2
