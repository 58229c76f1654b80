"""``repro_torch.marl.rollout`` against ``repro.marl.rollout`` on a toy
``step_fn``: the same keys (the port's threefry is bit for bit
``jax.random``'s) drive a counter carry and a categorical policy step,
and the stacked (T, E, ...) trajectory, the final carry and the
env-major swap agree bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import jkey_to_torch
from repro.marl import rollout as jrollout
from repro_torch import random as R
from repro_torch.marl import rollout
from repro_torch.tree import leaves

T, E, A, H = 5, 3, 4, 2


def _jax_step(carry, key):
    k1, k2 = jax.random.split(key)
    logits = jax.random.uniform(k1, (E, A))
    action = jax.random.categorical(k2, logits)
    reward = jnp.take_along_axis(logits, action[:, None], 1)[:, 0]
    done = reward > 0.8
    tr = jrollout.Transition(obs=carry["obs"], action=action,
                             logp=reward - logits.max(-1),
                             value=logits[:, 0] + logits[:, 1],
                             reward=reward,
                             done=done, h_pre=carry["h"])
    h = jnp.where(done[:, None], 0.0, carry["h"] + reward[:, None])
    return {"obs": carry["obs"] + 1, "h": h}, tr


def _torch_step(carry, key):
    k1, k2 = R.split(key)
    logits = R.uniform(k1, (E, A))
    action = R.categorical(k2, logits)
    reward = torch.take_along_dim(logits, action[:, None], 1)[:, 0]
    done = reward > 0.8
    tr = rollout.Transition(obs=carry["obs"], action=action,
                            logp=reward - logits.max(-1).values,
                            value=logits[:, 0] + logits[:, 1],
                            reward=reward,
                            done=done, h_pre=carry["h"])
    h = torch.where(done[:, None], 0.0, carry["h"] + reward[:, None])
    return {"obs": carry["obs"] + 1, "h": h}, tr


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_rollout_and_env_major_match_reference():
    jkeys = jax.random.split(jax.random.PRNGKey(3), T)
    jcarry0 = {"obs": jnp.zeros((E, 2), jnp.int32),
               "h": jnp.zeros((E, H), jnp.float32)}
    jfinal, jtraj = jrollout.rollout((jcarry0, jkeys), T, _jax_step)

    keys = R.split(R.key(3), T)
    np.testing.assert_array_equal(keys.numpy(), _np(jkey_to_torch(jkeys)))
    carry0 = {"obs": torch.zeros((E, 2), dtype=torch.int64),
              "h": torch.zeros((E, H))}
    final, traj = rollout.rollout((carry0, keys), T, _torch_step)

    assert isinstance(traj, rollout.Transition)
    assert traj._fields == jrollout.Transition._fields
    for name in traj._fields:
        got, want = getattr(traj, name), getattr(jtraj, name)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(_np(got), np.asarray(want),
                                      err_msg=name)
    assert bool(traj.done.any()) and not bool(traj.done.all())
    for got, want in zip(leaves(final), jax.tree.leaves(jfinal)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    env_major = rollout.time_major_to_env_major(traj)
    jenv_major = jrollout.time_major_to_env_major(jtraj)
    assert isinstance(env_major, rollout.Transition)
    for got, want in zip(env_major, jenv_major):
        assert tuple(got.shape) == want.shape == (E, T) + want.shape[2:]
        np.testing.assert_array_equal(_np(got), np.asarray(want))
