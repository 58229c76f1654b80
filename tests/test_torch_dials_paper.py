"""The paper's DIALS configurations on the port against the reference's
loop driver, at narrow widths: (warehouse, GRU policy) and (traffic, FNN
policy), each one round from the reference's ``init`` state (carried
over by ``repro_torch.convert``), and the reference's own checkpoint of
round 0 resumed by the port's trainer, whose round 1 matches the
reference's.

Tolerances (those of ``tests/test_torch_dials.py``): the collect's
u/resets/feats bitwise; aip_ce_before/aip_ce_after within 1e-5,
gs_return and ials_reward within 1e-6; policy and AIP params within
1e-5; the IALS env state, keys and counters bitwise."""
import os
import shutil

import jax
import pytest

from _torch_parity import assert_tree_equal, tree_maxdiff
from repro.checkpoint import ckpt as jckpt
from repro.core import dials as jdials
from repro.core import influence as jinf
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro.obs import metrics as jmetrics
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import dials, influence
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo

ENV = dict(side=2, horizon=16)
POLICY = {"warehouse": dict(kind="gru", hidden=(16,), gru_hidden=8),
          "traffic": dict(kind="fnn", hidden=(16,))}
AIP = dict(kind="gru", hidden=(16,), gru_hidden=8, epochs=3, batch=4)
DIALS = dict(aip_refresh=2, collect_envs=4, collect_steps=16, n_envs=4,
             rollout_steps=8, eval_episodes=2)
PPO = dict(epochs=1, minibatches=2)


def _reference(env, rounds, ckpt_dir=None):
    jmod, jcfg = jreg.make(env, **ENV)
    info = jcfg.info()
    return jdials.DIALSTrainer(
        jmod, jcfg,
        jpol.PolicyConfig(info.obs_dim, info.n_actions, use_kernels="off",
                          **POLICY[env]),
        jinf.AIPConfig(info.alsh_dim, info.n_influence, use_kernels="off",
                       **AIP),
        jppo.PPOConfig(use_kernels="off", **PPO),
        jdials.DIALSConfig(shards=1, use_kernels="off", outer_rounds=rounds,
                           ckpt_dir=ckpt_dir, **DIALS))


def _port(env, rounds, ckpt_dir=None):
    mod, cfg = registry.make(env, **ENV)
    info = cfg.info()
    return dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions,
                                      **POLICY[env]),
        influence.AIPConfig(info.alsh_dim, info.n_influence, **AIP),
        ppo.PPOConfig(**PPO),
        dials.DIALSConfig(outer_rounds=rounds, ckpt_dir=ckpt_dir, **DIALS),
        device="cpu")


@pytest.fixture(scope="module")
def warehouse_run(tmp_path_factory):
    """The reference's two rounds on (warehouse, GRU policy), with its
    checkpoints of both."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jtr = _reference("warehouse", 2, d)
    key = jax.random.PRNGKey(0)
    state0 = jax.device_get(jtr.init(key))
    jstate, jhist = jtr.run(key)
    return jtr, key, state0, jax.device_get(jstate), jhist, d


def _check_round(jrec, trec, jstate, tstate):
    assert jmetrics.validate_round(trec) == []
    for k, tol in (("aip_ce_before", 1e-5), ("aip_ce_after", 1e-5),
                   ("gs_return", 1e-6), ("ials_reward", 1e-6)):
        assert abs(jrec[k] - trec[k]) <= tol, (k, jrec[k], trec[k])
    for k in ("round", "data_round", "stale_forced", "staleness_min",
              "staleness_max", "n_shards"):
        assert jrec[k] == trec[k], k
    assert tree_maxdiff(jstate["ials"]["params"],
                        tstate["ials"]["params"]) < 1e-5
    assert tree_maxdiff(jstate["aips"], tstate["aips"]) < 1e-5
    for k in ("locals", "obs", "prev_a", "iter", "key"):
        assert_tree_equal(jstate["ials"][k], tstate["ials"][k])


def _one_round(jtr, key, state0, jrec, jstate, env):
    tr = _port(env, 1)
    tstate, thist = tr.run(R.key(0),
                           state=convert.from_jax_state(state0, "cpu"))
    _check_round(jrec, thist[0], jstate, tstate)
    # the round's collect, bit for bit (the same params and round key)
    kc = jax.random.split(jax.random.fold_in(key, 0), 3)[0]
    assert_tree_equal(
        jtr.collect(state0["ials"]["params"], kc),
        tr.collect(convert.from_jax_params(state0["ials"]["params"], "cpu"),
                   R.split(R.fold_in(R.key(0), 0), 3)[0]))


def test_warehouse_recurrent_policy_round_matches_reference(warehouse_run):
    jtr, key, state0, _, jhist, d = warehouse_run
    # the reference's state after round 0, from its own checkpoint
    after0, step = jckpt.restore(os.path.join(d, "step_1"),
                                 jtr._state_struct(state0))
    assert step == 1
    _one_round(jtr, key, state0, jhist[0], after0, "warehouse")


def test_traffic_round_matches_reference():
    jtr = _reference("traffic", 1)
    key = jax.random.PRNGKey(0)
    state0 = jax.device_get(jtr.init(key))
    jstate, jhist = jtr.run(key)
    _one_round(jtr, key, state0, jhist[0], jax.device_get(jstate),
               "traffic")


def test_reference_checkpoint_resumes_in_the_port(warehouse_run, tmp_path):
    """The port's manager restores the reference's step-1 checkpoint (its
    uint32 keys and int32 counters into the port's int64) with its
    ``reports``; the port's round 1 matches the reference's."""
    _, _, _, jstate, jhist, d = warehouse_run
    shutil.copytree(os.path.join(d, "step_1"), tmp_path / "step_1")
    tr = _port("warehouse", 2, str(tmp_path))
    tstate, thist = tr.run(R.key(123))      # the checkpoint's key wins
    assert [r["round"] for r in thist] == [1]
    assert tr._resume_extra["reports"] == [0] * tr.info.n_agents
    _check_round(jhist[1], thist[0], jstate, tstate)
    assert_tree_equal(jstate["key"], tstate["key"])
