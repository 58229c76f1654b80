"""The slice as a whole: one DIALS loop round of the port against the
reference's loop driver on warehouse side=2 at narrow widths, both from
the reference's ``init`` state (carried over by ``repro_torch.convert``).

Tolerances (also in PERF.md): the collect's u/resets/feats bitwise; the
round record's aip_ce_before/aip_ce_after within 1e-5, gs_return and
ials_reward within 1e-6; final policy and AIP params within 1e-5; the
IALS env state, keys and counters bitwise. No argmax tie from a last-ulp
logit difference occurs at this size (the sampled actions, and with them
every discrete field, are bitwise)."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal, to_torch, tree_maxdiff
from repro.core import dials as jdials
from repro.core import influence as jinf
from repro.distributed import fault as jfault
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro.obs import metrics as jmetrics
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import dials, gs, ials, influence
from repro_torch.distributed import fault
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo, runner
from repro_torch.obs import metrics

ENV = dict(side=2, horizon=16)
POLICY = dict(hidden=(16,))
AIP = dict(kind="gru", hidden=(16,), gru_hidden=8, epochs=3, batch=4)
DIALS = dict(outer_rounds=1, aip_refresh=2, collect_envs=4,
             collect_steps=16, n_envs=4, rollout_steps=8, eval_episodes=2)
PPO = dict(epochs=1, minibatches=2)


def _port_trainer(device="cpu", **overrides):
    mod, cfg = registry.make("warehouse", **ENV)
    info = cfg.info()
    return dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions, **POLICY),
        influence.AIPConfig(info.alsh_dim, info.n_influence, **AIP),
        ppo.PPOConfig(**PPO), dials.DIALSConfig(**{**DIALS, **overrides}),
        device=device)


def test_one_loop_round_matches_reference():
    jmod, jcfg = jreg.make("warehouse", **ENV)
    info = jcfg.info()
    jtr = jdials.DIALSTrainer(
        jmod, jcfg,
        jpol.PolicyConfig(info.obs_dim, info.n_actions, use_kernels="off",
                          **POLICY),
        jinf.AIPConfig(info.alsh_dim, info.n_influence, use_kernels="off",
                       **AIP),
        jppo.PPOConfig(use_kernels="off", **PPO),
        jdials.DIALSConfig(shards=1, use_kernels="off", **DIALS))
    key = jax.random.PRNGKey(0)
    state0 = jax.device_get(jtr.init(key))
    jstate, jhist = jtr.run(key)

    tr = _port_trainer()
    tstate, thist = tr.run(R.key(0),
                           state=convert.from_jax_state(state0, "cpu"))
    jrec, trec = jhist[0], thist[0]
    assert jmetrics.validate_round(trec) == []
    for k, tol in (("aip_ce_before", 1e-5), ("aip_ce_after", 1e-5),
                   ("gs_return", 1e-6), ("ials_reward", 1e-6)):
        assert abs(jrec[k] - trec[k]) <= tol, (k, jrec[k], trec[k])
    for k in ("round", "data_round", "stale_forced", "staleness_min",
              "staleness_max", "n_shards"):
        assert jrec[k] == trec[k], k

    # the round's collect, bit for bit (the same params and round key)
    kc = jax.random.split(jax.random.fold_in(key, 0), 3)[0]
    jdata = jtr.collect(state0["ials"]["params"], kc)
    tdata = tr.collect(convert.from_jax_params(state0["ials"]["params"],
                                               "cpu"),
                       R.split(R.fold_in(R.key(0), 0), 3)[0])
    assert_tree_equal(jdata, tdata)

    assert tree_maxdiff(jstate["ials"]["params"],
                        tstate["ials"]["params"]) < 1e-5
    assert tree_maxdiff(jstate["aips"], tstate["aips"]) < 1e-5
    for k in ("locals", "obs", "prev_a", "iter", "key"):
        assert_tree_equal(jstate["ials"][k], tstate["ials"][k])


def test_port_round_records_validate_and_refuse_unported_options(tmp_path):
    tr = _port_trainer(outer_rounds=2)
    _, hist = tr.run(R.key(3))
    assert [r["round"] for r in hist] == [0, 1]
    for rec in hist:
        assert jmetrics.validate_round(rec) == []
        assert rec["kernels"] == "policy=plain,aip=plain,ppo=plain"
    # ckpt_dir, the async collect and telemetry are ported
    # (tests/test_torch_checkpoint.py, test_torch_async_collect.py,
    # test_torch_obs.py), and so is the sharded round
    # (tests/test_torch_sharded.py); the first two are not, with shards
    for ok in (dict(async_collect=True),
               dict(telemetry_dir=str(tmp_path / "tel"))):
        _, got = _port_trainer(outer_rounds=2, **ok).run(R.key(3))
        assert [jmetrics.validate_round(r) for r in got] == [[], []]
    assert [r["data_round"] for r in got] == [0, 1]
    for bad in (dict(shards=2, async_collect=True),
                dict(shards=2, ckpt_dir=str(tmp_path / "ckpt"))):
        with pytest.raises(NotImplementedError, match="not ported"):
            _port_trainer(**bad)


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port_trainer(device="cuda")
    mod, cfg = registry.make("warehouse", **ENV)
    info = cfg.info()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dials.DIALSTrainer(
            mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions),
            influence.AIPConfig(info.alsh_dim, info.n_influence),
            ppo.PPOConfig(), dials.DIALSConfig())
    pc = policy.PolicyConfig(info.obs_dim, info.n_actions)
    ac = influence.AIPConfig(info.alsh_dim, info.n_influence)
    for factory in (
            lambda: gs.make_collector(mod, cfg, pc, n_envs=2, steps=2),
            lambda: ials.make_ials_trainer(mod, cfg, pc, ac, ppo.PPOConfig(),
                                           n_envs=2, rollout_steps=2),
            lambda: runner.make_gs_eval(mod, cfg, pc),
            lambda: runner.make_gs_trainer(mod, cfg, pc, ppo.PPOConfig(),
                                           runner.RunConfig()),
            lambda: gs.make_collector_into(mod, cfg, pc, n_envs=2,
                                           steps=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            factory()
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        _port_trainer(use_kernels="on").run(R.key(0))


def test_freshness_gate_and_masked_update_match():
    fresh = np.array([1, 0, 0, 1], np.float32)
    reports = np.array([3, 3, 0, 1], np.int32)
    jout = jfault.freshness_gate(fresh, reports, 4, 4, 2)
    tout = fault.freshness_gate(torch.from_numpy(fresh),
                                torch.from_numpy(reports).long(), 4, 4, 2)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    old = {"w": np.zeros((4, 2, 3), np.float32)}
    new = {"w": np.ones((4, 2, 3), np.float32)}
    assert_tree_equal(jfault.masked_tree_update(old, new, jout[0]),
                      fault.masked_tree_update(to_torch(old), to_torch(new),
                                               tout[0]))
    stats = metrics.staleness_stats(tout[1], 4)
    jstats = jmetrics.staleness_stats(jout[1], 4)
    for k in stats:
        assert float(stats[k]) == float(jstats[k])
    assert metrics.ROUND_FIELDS == jmetrics.ROUND_FIELDS
