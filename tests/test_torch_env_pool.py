"""The port's env pools (``repro_torch.core.env_pool``, ``core.gs``): the
reference's per-stream key chains bit for bit, S-prefix invariance of
the collect inside the port, and the rank-broadcast reset."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_tree_equal, jkey_to_torch, to_torch
from repro.core import env_pool as jpool
from repro.envs import registry as jreg
from repro_torch import random as R
from repro_torch.core import env_pool, gs as gs_mod
from repro_torch.envs import registry
from repro_torch.marl import policy as policy_mod


def test_stream_and_step_keys_bitwise():
    key = jax.random.PRNGKey(3)
    small = jpool.stream_keys(key, 8)
    tsmall = env_pool.stream_keys(R.key(3), 8)
    assert_tree_equal(small, tsmall)
    assert_tree_equal(jpool.init_keys(small), env_pool.init_keys(tsmall))
    assert_tree_equal(jpool.step_keys(small, 5, 3),
                      env_pool.step_keys(tsmall, 5, 3))
    # per-agent stream chains, as the IALS builds them
    ks = jax.random.split(key, 4)
    assert_tree_equal(jax.vmap(lambda k: jpool.stream_keys(k, 6))(ks),
                      env_pool.stream_keys(jkey_to_torch(ks), 6))
    # prefix invariance of the chain roots
    assert torch.equal(env_pool.stream_keys(R.key(3), 1024)[:8], tsmall)


def test_gs_pool_trajectory_bitwise_under_fixed_actions():
    """Steps with auto-reset under a fixed action schedule: states,
    observations, rewards, influence and done flags all equal the
    reference's."""
    jmod, jcfg = jreg.make("warehouse", side=2, horizon=5)
    mod, cfg = registry.make("warehouse", side=2, horizon=5)
    n_streams, n = 3, cfg.n_agents
    jp = jpool.GSPool(jmod, jcfg, n_streams)
    p = env_pool.GSPool(mod, cfg, n_streams)
    skeys = jpool.stream_keys(jax.random.PRNGKey(0), n_streams)
    tkeys = jkey_to_torch(skeys)
    step = jax.jit(jp.step_reset)
    jenv, env = jp.init(skeys), p.init(tkeys)
    assert_tree_equal(jenv, env)
    actions = np.random.RandomState(0).randint(0, 5, (12, n_streams, n))
    for t in range(12):
        k_env, k_reset = jpool.step_keys(skeys, t, 2)
        tk_env, tk_reset = env_pool.step_keys(tkeys, t, 2)
        jout = step(jenv, jnp.asarray(actions[t]), k_env, k_reset)
        out = p.step_reset(env, torch.from_numpy(actions[t]), tk_env,
                           tk_reset)
        assert_tree_equal(jout, out)
        jenv, env = jout[0], out[0]


def test_collector_stream_prefix_bitwise():
    """S=8 is bitwise the first 8 streams of S=64: per-stream keys make
    every draw depend on (key, s, t), never on the pool width."""
    mod, cfg = registry.make("warehouse", side=2, horizon=6)
    info = cfg.info()
    pc = policy_mod.PolicyConfig(info.obs_dim, info.n_actions, hidden=(8,))
    params = policy_mod.policy_init(R.split(R.key(0), info.n_agents), pc)
    small = gs_mod.make_collector(mod, cfg, pc, n_envs=8, steps=10,
                                  device="cpu")(params, R.key(7))
    wide = gs_mod.make_collector(mod, cfg, pc, n_envs=64, steps=10,
                                 device="cpu")(params, R.key(7))
    for k in small:
        assert torch.equal(small[k], wide[k][:, :8]), k
    # every episode start is flagged, including t=0
    assert bool((small["resets"][:, :, 0] == 1).all())
    assert bool((small["resets"][:, :, 6] == 1).all())


def test_reset_where_broadcasts_by_rank():
    done = torch.tensor([True, False])
    fresh = {"a": torch.zeros(2), "b": torch.zeros(2, 3),
             "c": torch.zeros(2, 3, 4)}
    cur = {k: torch.ones_like(v) for k, v in fresh.items()}
    out = env_pool.reset_where(done, fresh, cur)
    for v in out.values():
        assert float(v[0].sum()) == 0 and bool((v[1] == 1).all())
    h, a = env_pool.zero_on_done(done, (torch.ones(2, 5),
                                        torch.tensor([3, 4])))
    assert h[0].sum() == 0 and h[1].sum() == 5
    assert a.tolist() == [0, 4]


def test_split_dataset_holds_out_last_streams():
    data = {k: torch.arange(2 * 5 * 3).reshape(2, 5, 3).float()
            for k in ("feats", "u", "resets")}
    train, held = gs_mod.split_dataset(data, 1)
    assert train["feats"].shape == (2, 4, 3)
    assert torch.equal(held["u"], data["u"][:, 4:])
    same = gs_mod.split_dataset(data, 0)
    assert same[0] is data and same[1] is data
    np.testing.assert_raises(ValueError, gs_mod.split_dataset, data, 5)
    assert to_torch(np.zeros(2, np.uint32)).dtype == torch.int64
