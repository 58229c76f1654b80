"""The sharded runtime's single-process pieces against the reference: the
env hooks of the spatial decomposition (``region_partition``,
``boundary_influence``) bit for bit on seeded batched states, the
``DIALS_*`` bootstrap contract, the runtime helpers, and one round of
the port's one-shard ``ShardedDIALSRunner`` against the reference's
(``repro.core.dials_sharded`` on a one-device mesh) from the same state
carried over by ``repro_torch.convert``.

Tolerances: AIP params 1e-6, held-out CE 1e-5 and GS return 5e-2, the
reference's for a sharded round against the loop
(``tests/_multidevice_check.py``); the IALS reward 1e-5, as the CE;
policy params 1e-6, not the reference's 1e-2: the round's 4 optimizer
steps move no parameter more than about 1e-3 from its init, so 1e-2
would pass a skipped update, and the port stays within 3e-8 of the
reference here. The sharded collect is the reference's replicated
dataset bit for bit."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_tree_equal, jkey_to_torch, to_np,
                           to_torch, tree_maxdiff)
from repro.core import dials as jdials
from repro.core import dials_sharded as jdials_sharded
from repro.core import gs as jgs
from repro.core import influence as jinf
from repro.distributed import bootstrap as jboot
from repro.distributed import runtime as jruntime
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro_torch import convert
from repro_torch.core import dials, dials_sharded, gs_sharded, influence
from repro_torch.distributed import bootstrap, collectives, runtime
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo
from repro_torch.tree import leaves

ENVS = ("warehouse", "traffic", "powergrid", "supplychain")
TOL = {"aips": 1e-6, "policy": 1e-6, "ce": 1e-5, "gs_return": 5e-2}


# ---------------------------------------------------------------------------
# env hooks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env", ENVS)
def test_env_hooks_bitwise(env):
    """region_partition for every block count 1..5 (the same assignment,
    or a ValueError on both sides) and boundary_influence on 3 streams of
    seeded states, joint actions and exogenous draws, against the
    reference's vmapped over the streams."""
    side = 4 if env == "traffic" else 3
    jmod, jcfg = jreg.make(env, side=side, horizon=12)
    mod, cfg = registry.make(env, side=side, horizon=12)
    info = cfg.info()
    for blocks in range(1, 6):
        try:
            want = np.asarray(jmod.region_partition(jcfg, blocks))
        except ValueError:
            with pytest.raises(ValueError):
                mod.region_partition(cfg, blocks)
            continue
        np.testing.assert_array_equal(mod.region_partition(cfg, blocks),
                                      want)
    boundary = jax.jit(jax.vmap(lambda s, a, x: jmod.boundary_influence(
        s, a, x, jcfg)))
    rng = np.random.default_rng(7)
    for trial in range(3):
        keys = jax.random.split(jax.random.PRNGKey(trial), 6)
        states = jax.vmap(lambda k: jmod.gs_init(k, jcfg))(keys[:3])
        exo = jax.vmap(lambda k: jmod.gs_exo(k, jcfg))(keys[3:])
        actions = jnp.asarray(rng.integers(0, info.n_actions,
                                           (3, info.n_agents)), jnp.int32)
        jloc = jax.vmap(lambda s: jmod.gs_locals(s, jcfg))(states)
        want = boundary(jloc, actions, exo)
        got = mod.boundary_influence(to_torch(jloc), to_torch(actions),
                                     to_torch(exo), cfg)
        assert got.dtype == torch.float32
        assert_tree_equal(want, got)
        # the hook equals the GS step's realized u
        u = mod.gs_step_given(to_torch(states), to_torch(actions),
                              to_torch(exo), cfg)[3]
        assert torch.equal(u, got)


def test_traffic_partition_refuses_partial_row_bands():
    mod, cfg = registry.make("traffic", side=3)
    with pytest.raises(ValueError, match="cannot split into 2 row bands"):
        mod.region_partition(cfg, 2)
    ok, why = gs_sharded.partition_supported(mod, cfg, 2)
    assert not ok and "row bands" in why
    assert gs_sharded.partition_supported(mod, cfg, 3) == (True, "")


# ---------------------------------------------------------------------------
# the DIALS_* bootstrap contract
# ---------------------------------------------------------------------------
ENVIRONS = [
    {},
    {"DIALS_COORDINATOR": "127.0.0.1:1234", "DIALS_NUM_PROCESSES": "2",
     "DIALS_PROCESS_ID": "1"},
    {"DIALS_COORDINATOR": "h:1", "DIALS_NUM_PROCESSES": "4",
     "DIALS_PROCESS_ID": "0", "DIALS_LOCAL_DEVICES": "1"},
    {"DIALS_COORDINATOR": "h:1", "DIALS_NUM_PROCESSES": "2"},
    {"DIALS_COORDINATOR": "h:1", "DIALS_NUM_PROCESSES": "2",
     "DIALS_PROCESS_ID": "2"},
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


def _fields(cfg):
    return None if cfg is None else (cfg.coordinator, cfg.num_processes,
                                     cfg.process_id, cfg.local_devices)


@pytest.mark.parametrize("environ", ENVIRONS,
                         ids=["none", "full", "local1", "partial", "range"])
def test_config_from_env_matches_reference(environ):
    want = _outcome(lambda: _fields(jboot.config_from_env(environ)))
    got = _outcome(lambda: _fields(bootstrap.config_from_env(environ)))
    assert got == want
    if isinstance(want, tuple) and want[0] != "ValueError":
        assert bootstrap.config_from_env(environ).env() == \
            jboot.config_from_env(environ).env()


ARGVS = [[], ["--num-processes", "2", "--coordinator", "a:9",
              "--process-id", "1"],
         ["--process-id", "0"], ["--num-processes", "2"],
         ["--local-devices", "1"]]


@pytest.mark.parametrize("argv", ARGVS,
                         ids=["empty", "full", "pid", "no-coord", "local1"])
def test_config_from_args_matches_reference(argv):
    environ = {"DIALS_COORDINATOR": "e:7", "DIALS_NUM_PROCESSES": "3",
               "DIALS_PROCESS_ID": "2"} if argv == ["--process-id",
                                                    "0"] else {}
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jboot.add_arguments(jp)
    bootstrap.add_arguments(tp)
    assert [a.dest for a in tp._actions] == [a.dest for a in jp._actions]
    want = _outcome(lambda: _fields(jboot.config_from_args(
        jp.parse_args(argv), environ)))
    got = _outcome(lambda: _fields(bootstrap.config_from_args(
        tp.parse_args(argv), environ)))
    assert got == want


def test_bootstrap_refusals_and_single_process_context():
    ctx = bootstrap.bootstrap(environ={})
    assert (ctx.process_id, ctx.num_processes, ctx.initialized,
            ctx.is_primary, ctx.distributed) == (0, 1, False, True, False)
    env = {"DIALS_COORDINATOR": "h:1", "DIALS_NUM_PROCESSES": "2",
           "DIALS_PROCESS_ID": "0", "DIALS_LOCAL_DEVICES": "4"}
    assert jboot.config_from_env(env).local_devices == 4
    with pytest.raises(ValueError, match="one shard per process"):
        bootstrap.config_from_env(env)
    # an external coordinator is no longer refused: without a group
    # declared it changes nothing (tests/test_torch_recovery_*.py run it)
    for flag in ("1", "0"):
        env = {"DIALS_COORDINATOR_EXTERNAL": flag}
        assert bootstrap.config_from_env(env) is None
        assert not bootstrap.bootstrap(environ=env).initialized


# ---------------------------------------------------------------------------
# runtime helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_agents,n_dev", [(4, 8), (4, 3), (25, 8), (7, 2),
                                            (16, 16)])
def test_choose_shards_matches_reference(n_agents, n_dev):
    assert runtime.choose_shards(n_agents, n_dev) == \
        jruntime.choose_shards(n_agents, n_dev)


def test_local_slice_struct_and_one_shard_mesh():
    tree = {"a": torch.zeros((4, 3)), "b": torch.zeros((4,),
                                                       dtype=torch.int32)}
    want = jruntime.local_slice_struct(
        {"a": jnp.zeros((4, 3)), "b": jnp.zeros((4,), jnp.int32)}, 2)
    sl = runtime.local_slice_struct(tree, 2)
    for k in tree:
        assert tuple(sl[k].shape) == tuple(want[k].shape)
        assert sl[k].device.type == "meta"
    assert sl["b"].dtype == torch.int32
    with pytest.raises(ValueError, match="divisible"):
        runtime.local_slice_struct(tree, 3)
    # one shard, no group: placement and gather are the identity
    mesh = runtime.shard_mesh(device="cpu")
    assert (mesh.n_shards, mesh.rank, mesh.group) == (1, 0, None)
    assert runtime.spare_device(1) is None
    x = {"x": torch.arange(8.0).reshape(4, 2), "n": 3}
    placed = runtime.shard_agent_tree(x, mesh)
    assert torch.equal(placed["x"], x["x"]) and placed["n"] == 3
    assert placed["x"].data_ptr() != x["x"].data_ptr()
    assert torch.equal(runtime.fetch_tree(placed, mesh)["x"], x["x"])
    prev, nxt = collectives.halo_exchange(x["x"], mesh)
    assert prev is x["x"] and nxt is x["x"]
    with pytest.raises(ValueError, match="one shard per process"):
        runtime.shard_mesh(2, device="cpu")


def test_collective_tables_cover_the_running_torch(monkeypatch):
    runtime.validate_collective_tables()
    live = runtime.live_collective_prims()
    assert {"c10d.allreduce_", "c10d.send", "c10d.recv_"} <= live
    monkeypatch.setattr(runtime, "COLLECTIVE_PRIMS",
                        runtime.COLLECTIVE_PRIMS - {"c10d.allreduce_"})
    with pytest.raises(AssertionError, match="c10d.allreduce_"):
        runtime.validate_collective_tables()


# ---------------------------------------------------------------------------
# one shard against the reference's one-device mesh
# ---------------------------------------------------------------------------
SMALL = dict(outer_rounds=1, aip_refresh=2, collect_envs=2,
             collect_steps=16, n_envs=2, rollout_steps=8, eval_episodes=2)


def _configs(info, jax_side: bool):
    pol, aip, ppo_mod = (jpol, jinf, jppo) if jax_side else (policy,
                                                              influence, ppo)
    off = {"use_kernels": "off"} if jax_side else {}
    return (pol.PolicyConfig(info.obs_dim, info.n_actions, hidden=(16,),
                             gru_hidden=8, **off),
            aip.AIPConfig(info.alsh_dim, info.n_influence, hidden=(16,),
                          gru_hidden=8, epochs=2, batch=16, **off),
            ppo_mod.PPOConfig(epochs=1, minibatches=2, **off))


def test_one_shard_round_matches_reference():
    """The reference's fused round on a one-device mesh and the port's
    one-shard ``round`` from the same carry and key: the record and the
    carry to the sharded-against-loop tolerances, the discrete IALS state
    bit for bit."""
    jmod, jcfg = jreg.make("traffic", horizon=16)
    mod, cfg = registry.make("traffic", horizon=16)
    info = cfg.info()
    jdc = jdials.DIALSConfig(use_kernels="off", **SMALL)
    jrun = jdials_sharded.ShardedDIALSRunner(
        jmod, jcfg, *_configs(info, True), jdc, n_shards=1)
    jtr = jdials.DIALSTrainer(jmod, jcfg, *_configs(info, True), jdc)
    key = jax.random.PRNGKey(0)
    # init compiled as one program (called as is, each op compiles on its
    # own); both rounds start from this state
    state0 = jax.device_get(jax.jit(jtr.init)(key))
    n = info.n_agents
    reports = np.full((n,), -1, np.int32)
    jcarry = jrun.shard_carry({"aips": state0["aips"],
                               "ials": state0["ials"], "reports": reports})
    jcarry, jrec = jrun.round(jcarry, key, 0, jnp.ones((n,), jnp.float32))
    jcarry = jax.device_get(jcarry)

    run = dials_sharded.ShardedDIALSRunner(
        mod, cfg, *_configs(info, False), dials.DIALSConfig(**SMALL),
        n_shards=1, device="cpu")
    assert run.use_sharded_gs and jrun.use_sharded_gs
    tstate = convert.from_jax_state(state0, "cpu")
    carry = run.shard_carry({"aips": tstate["aips"], "ials": tstate["ials"],
                             "reports": torch.full((n,), -1)})
    carry, rec = run.round(carry, jkey_to_torch(key), 0, torch.ones(n))
    for k, tol in (("aip_ce_before", TOL["ce"]), ("aip_ce_after", TOL["ce"]),
                   ("gs_return", TOL["gs_return"]),
                   ("ials_reward", TOL["ce"])):
        assert abs(float(jrec[k]) - float(rec[k])) <= tol, k
    for k in ("data_round", "stale_forced", "staleness_min",
              "staleness_max"):
        assert int(jrec[k]) == int(rec[k]), k
    assert tree_maxdiff(jcarry["aips"], carry["aips"]) <= TOL["aips"]
    assert tree_maxdiff(jcarry["ials"]["params"],
                        carry["ials"]["params"]) <= TOL["policy"]
    for k in ("locals", "prev_a", "iter", "key"):
        assert_tree_equal(jcarry["ials"][k], carry["ials"][k])
    np.testing.assert_array_equal(to_np(carry["reports"]),
                                  np.asarray(jcarry["reports"]))


@pytest.mark.parametrize("env", ("supplychain", "warehouse"))
def test_one_shard_collect_is_the_reference_dataset(env):
    """The region-decomposed collect on a one-shard mesh emits the
    reference's replicated ``make_collector`` dataset bit for bit, with
    one halo exchange a step and no point-to-point call (the one-shard
    ring is the identity), and audits halo-only."""
    jmod, jcfg = jreg.make(env, side=2, horizon=16)
    mod, cfg = registry.make(env, side=2, horizon=16)
    info = cfg.info()
    jpc, _, _ = _configs(info, True)
    pc, _, _ = _configs(info, False)
    params = jax.jit(jax.vmap(lambda k: jpol.policy_init(k, jpc)))(
        jax.random.split(jax.random.PRNGKey(3), info.n_agents))
    kc = jax.random.PRNGKey(4)
    want = jgs.make_collector(jmod, jcfg, jpc, n_envs=3, steps=16)(params,
                                                                  kc)
    mesh = runtime.shard_mesh(1, device="cpu")
    collect = gs_sharded.make_sharded_collector(mod, cfg, pc, n_envs=3,
                                                steps=16, mesh=mesh)
    tparams = to_torch(params)
    collectives.reset_stats()
    got = collect(tparams, jkey_to_torch(kc))
    assert_tree_equal(want, got)
    assert collectives.STATS["halo_exchanges"] == 16
    assert collectives.STATS["p2p_calls"] == 0
    gs_sharded.audit_halo_contract(collect, tparams, jkey_to_torch(kc))
    for x in leaves(got):
        assert x.shape[:3] == (info.n_agents, 3, 16)
