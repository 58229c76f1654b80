"""The port's collect plumbing and GS baseline: ``gs.make_collector_into``
and ``DeviceRing`` give bit for bit ``make_collector``'s datasets, and
``runner.make_gs_trainer`` (init, two train steps, eval) matches the
reference's on traffic side=2: params within 1e-5, metrics within 1e-6,
env state, observations and keys bitwise."""
import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import (assert_tree_equal, jkey_to_torch, to_torch,
                           tree_maxdiff)
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro.marl import runner as jrunner
from repro_torch import random as R
from repro_torch.core import gs
from repro_torch.distributed import async_collect
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo, runner


def _collectors(env="warehouse", kind="gru"):
    mod, cfg = registry.make(env, side=2, horizon=10)
    info = cfg.info()
    pc = policy.PolicyConfig(info.obs_dim, info.n_actions, kind=kind,
                             hidden=(16,), gru_hidden=8)
    kw = dict(n_envs=3, steps=12, device="cpu")
    params = policy.policy_init(R.split(R.key(5), info.n_agents), pc)
    return (gs.make_collector(mod, cfg, pc, **kw),
            gs.make_collector_into(mod, cfg, pc, **kw),
            lambda: gs.zero_dataset(cfg, **kw), params)


@pytest.mark.parametrize("env,kind", [("warehouse", "gru"),
                                      ("traffic", "fnn")])
def test_collect_into_equals_collect_from_garbage(env, kind):
    collect, collect_into, zeros, params = _collectors(env, kind)
    key = R.key(7)
    want = collect(params, key)
    garbage = {k: torch.full_like(v, float("nan"))
               for k, v in zeros().items()}
    got = collect_into(garbage, params, key)
    assert got["feats"].data_ptr() == garbage["feats"].data_ptr()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # resets mark each stream's first step
    assert bool((want["resets"][:, :, 0] == 1).all())


def test_device_ring_rotates_slots_bitwise():
    collect, collect_into, zeros, params = _collectors()
    ring = async_collect.DeviceRing(collect_into, zeros)
    assert ring.n_slots == 2
    keys = [R.key(k) for k in (1, 2, 3, 4)]
    outs = [ring.collect(params, k) for k in keys]
    ptr = lambda d: d["feats"].data_ptr()
    # two slots, reused in turn: no allocation past the first fill
    assert ptr(outs[0]) != ptr(outs[1])
    assert ptr(outs[2]) == ptr(outs[0]) and ptr(outs[3]) == ptr(outs[1])
    # each dataset is valid for slots - 1 = 1 later call: compare the
    # newest two with the plain collect
    for k, out in zip(keys[2:], outs[2:]):
        want = collect(params, k)
        for name in want:
            assert torch.equal(out[name], want[name]), name
    with pytest.raises(ValueError, match=">= 2 slots"):
        async_collect.DeviceRing(collect_into, zeros, slots=1)


def test_gs_trainer_matches_reference():
    jmod, jcfg = jreg.make("traffic", side=2, horizon=12)
    mod, cfg = registry.make("traffic", side=2, horizon=12)
    info = cfg.info()
    jpc = jpol.PolicyConfig(info.obs_dim, info.n_actions, hidden=(16,),
                            use_kernels="off")
    pc = policy.PolicyConfig(info.obs_dim, info.n_actions, hidden=(16,))
    jppo_cfg = jppo.PPOConfig(epochs=1, minibatches=2, use_kernels="off")
    ppo_cfg = ppo.PPOConfig(epochs=1, minibatches=2)
    run_cfg = dict(n_envs=4, rollout_steps=8)
    jinit, jtrain, jeval = jrunner.make_gs_trainer(
        jmod, jcfg, jpc, jppo_cfg, jrunner.RunConfig(**run_cfg))
    init, train, evaluate = runner.make_gs_trainer(
        mod, cfg, pc, ppo_cfg, runner.RunConfig(**run_cfg), device="cpu")

    key = jax.random.PRNGKey(3)
    # the reference's init compiled as one program (called as is, each op
    # compiles on its own)
    jstate = jax.device_get(jax.jit(jinit)(key))
    state = init(jkey_to_torch(key))
    for k in ("env", "obs", "h", "key", "iter"):
        assert_tree_equal(jstate[k], state[k])
    # the orthogonal init is QR-based on both sides: start the port from
    # the reference's params and optimizer state
    state = {**state, "params": to_torch(jstate["params"]),
             "opt": to_torch(jstate["opt"])}
    for _ in range(2):
        jstate, jm = jtrain(jstate)
        state, m = train(state)
        for k in jm:
            assert abs(float(jm[k]) - float(m[k])) <= 1e-6, (k, jm[k], m[k])
    for k in ("env", "obs", "h", "key", "iter"):
        assert_tree_equal(jstate[k], state[k])
    assert tree_maxdiff(jstate["params"], state["params"]) < 1e-5
    assert tree_maxdiff(jstate["opt"], state["opt"]) < 1e-5
    ek = jax.random.PRNGKey(11)
    jret = float(jeval(jstate["params"], ek, episodes=3))
    ret = float(evaluate(state["params"], jkey_to_torch(ek), episodes=3))
    assert abs(jret - ret) <= 1e-6, (jret, ret)
