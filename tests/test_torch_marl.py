"""The port's MARL pieces against the reference: the FNN and recurrent
policies and action sampling, AdamW and clipping, and one full
``ppo_update`` per agent with each policy (params within 1e-5), the
reference vmapped over agents."""
import jax
import numpy as np
import torch

from _torch_parity import jkey_to_torch, to_torch, tree_maxdiff
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro_torch.marl import policy, ppo
from repro_torch.optim import adamw, clip

OBS, ACT, AGENTS = 7, 5, 3


GRU_TOL = 1e-5


def _policy(seed=0, hidden=(16, 8), **kw):
    jpc = jpol.PolicyConfig(OBS, ACT, hidden=hidden, use_kernels="off", **kw)
    pc = policy.PolicyConfig(OBS, ACT, hidden=hidden, **kw)
    params = jax.jit(jax.vmap(lambda k: jpol.policy_init(k, jpc)))(
        jax.random.split(jax.random.PRNGKey(seed), AGENTS))
    return jpc, pc, jax.device_get(params)


def test_policy_apply_and_sample_action_match():
    jpc, pc, params = _policy()
    obs = np.random.RandomState(0).randn(AGENTS, 6, OBS).astype(np.float32)
    h = np.zeros((AGENTS, 6, pc.gru_hidden), np.float32)
    jl, jv, _ = jax.jit(jax.vmap(
        lambda p, o, hh: jpol.policy_apply(p, o, hh, jpc)))(params, obs, h)
    tl, tv, _ = policy.policy_apply(to_torch(params), torch.from_numpy(obs),
                                    torch.from_numpy(h), pc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(4), AGENTS * 6).reshape(
        AGENTS, 6, 2)
    ja, jlp = jax.jit(jax.vmap(jax.vmap(jpol.sample_action)))(keys, jl)
    ta, tlp = policy.sample_action(jkey_to_torch(keys), torch.from_numpy(
        np.asarray(jl)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6)


def test_adamw_and_clip_match():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(AGENTS, 4, 3).astype(np.float32),
              "b": rng.randn(AGENTS, 3).astype(np.float32)}
    grads = {k: 3 * rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    cfg = jadamw.AdamWConfig(weight_decay=0.1)
    jclipped, jnorm = jax.vmap(lambda g: jclip.clip_by_global_norm(g, 0.5))(
        grads)
    tclipped, tnorm = clip.clip_by_global_norm(to_torch(grads), 0.5)
    np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm), rtol=1e-6)
    assert tree_maxdiff(jclipped, tclipped) < 1e-6
    jopt = jax.vmap(jadamw.init)(params)
    topt = adamw.init(to_torch(params))
    for _ in range(3):
        jm, jopt = jax.vmap(lambda g, o: jadamw.update(g, o, 1e-2, cfg))(
            grads, jopt)
        tm, topt = adamw.update(to_torch(grads), topt, 1e-2,
                                adamw.AdamWConfig(weight_decay=0.1))
    assert tree_maxdiff(jm, tm) < 1e-6
    assert tree_maxdiff(jopt, topt) < 1e-6


def test_recurrent_policy_init_layout_matches():
    """``kind="gru"`` adds the reference's ``gru`` subtree (in_dim = the
    trunk's last width, hidden = gru_hidden) and heads on gru_hidden."""
    jpc, pc, params = _policy(kind="gru", gru_hidden=12)
    mine = policy.policy_init(
        torch.tensor(np.asarray(jax.random.split(jax.random.PRNGKey(0),
                                                 AGENTS)).astype(np.int64)),
        pc)
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)
    assert shapes(to_torch(params)) == shapes(mine)
    assert tuple(mine["gru"]["wh"].shape) == (AGENTS, 12, 36)


def test_recurrent_policy_apply_and_sequence_match():
    jpc, pc, params = _policy(seed=2, kind="gru", gru_hidden=12)
    rng = np.random.RandomState(1)
    b, t = 5, 9
    obs = rng.randn(AGENTS, b, OBS).astype(np.float32)
    h = (0.5 * rng.randn(AGENTS, b, 12)).astype(np.float32)
    jl, jv, jh = jax.jit(jax.vmap(
        lambda p, o, hh: jpol.policy_apply(p, o, hh, jpc)))(params, obs, h)
    tl, tv, th = policy.policy_apply(to_torch(params), torch.from_numpy(obs),
                                     torch.from_numpy(h), pc)
    for j, m in ((jl, tl), (jv, tv), (jh, th)):
        np.testing.assert_allclose(m.numpy(), np.asarray(j), atol=GRU_TOL)
    seq = rng.randn(AGENTS, b, t, OBS).astype(np.float32)
    resets = (rng.rand(AGENTS, b, t) < 0.2).astype(np.float32)
    jl, jv = jax.jit(jax.vmap(
        lambda p, o, hh, r: jpol.policy_sequence(p, o, hh, r, jpc)))(
        params, seq, h, resets)
    tl, tv = policy.policy_sequence(to_torch(params), torch.from_numpy(seq),
                                    torch.from_numpy(h),
                                    torch.from_numpy(resets), pc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=GRU_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=GRU_TOL)


def test_ppo_update_params_match_after_one_call():
    _ppo_update_case("fnn")


def test_recurrent_ppo_update_params_match_after_one_call():
    """The GRU policy's sequence recompute (with resets and a non-zero
    h0) under the gradient: params within GRU_TOL after one call."""
    _ppo_update_case("gru")


def _ppo_update_case(kind):
    jpc, pc, params = _policy(seed=1, kind=kind, gru_hidden=8)
    e, t = 8, 10
    rng = np.random.RandomState(3)
    traj = {"obs": rng.randn(AGENTS, e, t, OBS).astype(np.float32),
            "actions": rng.randint(0, ACT, (AGENTS, e, t)).astype(np.int32),
            "logp_old": -np.abs(rng.randn(AGENTS, e, t)).astype(np.float32),
            "adv": rng.randn(AGENTS, e, t).astype(np.float32),
            "ret": rng.randn(AGENTS, e, t).astype(np.float32),
            "values_old": rng.randn(AGENTS, e, t).astype(np.float32),
            "resets": (rng.rand(AGENTS, e, t) < 0.15).astype(np.float32),
            "h0": (0.3 * rng.randn(AGENTS, e, pc.gru_hidden))
            .astype(np.float32)}
    jcfg = jppo.PPOConfig(epochs=2, minibatches=2, use_kernels="off")
    cfg = ppo.PPOConfig(epochs=2, minibatches=2)
    keys = jax.random.split(jax.random.PRNGKey(31), AGENTS)
    jp, jo, jm = jax.jit(jax.vmap(lambda p, o, b, k: jppo.ppo_update(
        p, o, b, k, jpc, jcfg)))(params, jax.vmap(jadamw.init)(params),
                                 traj, keys)
    tparams = to_torch(params)
    tp, to, tm = ppo.ppo_update(tparams, adamw.init(tparams),
                                to_torch(traj), jkey_to_torch(keys), pc, cfg)
    assert tree_maxdiff(jp, tp) < 1e-5
    assert tree_maxdiff(jo, to) < 1e-5
    for k in ("loss", "pi_loss", "v_loss", "entropy", "gnorm"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-5, rtol=1e-5)
