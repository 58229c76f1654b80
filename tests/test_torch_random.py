"""The port's threefry key streams (``repro_torch.random``) against
``jax.random``: the same bits for every call the port makes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jkey_to_torch
from repro_torch import random as R


def test_threefry_partitionable_flag():
    """The port reproduces the partitionable threefry; the reference
    must run under it."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_key_split_fold_in_bits(seed):
    k, tk = jax.random.PRNGKey(seed), R.key(seed)
    np.testing.assert_array_equal(np.asarray(k), tk.numpy())
    for num in (2, 3, 16):
        np.testing.assert_array_equal(np.asarray(jax.random.split(k, num)),
                                      R.split(tk, num).numpy())
    for data in (0, 1, 7, 2**32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(k, data)),
            R.fold_in(tk, data).numpy())


def test_batched_keys_match_vmap():
    """Leading key dimensions batch exactly as the reference's vmap."""
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    tks = jkey_to_torch(ks)
    data = jnp.arange(6) * 11
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.fold_in)(ks, data)),
        R.fold_in(tks, torch.arange(6) * 11).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(ks)),
        R.split(tks, 4).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.3, (5,)))(
            ks)), R.bernoulli(tks, 0.3, (5,)).numpy())


def test_uniform_bernoulli_bits():
    k, tk = jax.random.PRNGKey(9), R.key(9)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, (4, 7))), R.uniform(tk, (4, 7)))
    for p in (0.02, 0.2, 0.5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(k, p, (41, 41))),
            R.bernoulli(tk, p, (41, 41)).numpy())
    probs = np.random.RandomState(0).rand(3, 12).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(k, jnp.asarray(probs))),
        R.bernoulli(tk, torch.from_numpy(probs)).numpy())


@pytest.mark.parametrize("lo,hi,shape", [(0, 5, (100, 2)), (0, 5, (2,)),
                                         (-3, 100000, (64,)),
                                         (0, 2**31 - 1, (64,))])
def test_randint_bits(lo, hi, shape):
    k, tk = jax.random.PRNGKey(11), R.key(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(k, shape, lo, hi)),
        R.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("n", [1, 7, 16, 128])
def test_permutation_bits(n):
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(ks)),
        R.permutation(jkey_to_torch(ks), n).numpy())


@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_categorical_bits_at_slice_logits(scale):
    """The collect draws per stream over (N agents, 5 actions), the IALS
    per (agent, stream) over 5 actions; logits at the init scale of the
    policy head (0.01) and at unit scale."""
    rng = np.random.RandomState(1)
    s, n, a = 8, 100, 5
    logits = (scale * rng.randn(s, n, a)).astype(np.float32)
    ks = jax.random.split(jax.random.PRNGKey(2), s)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(jax.random.categorical))(
            ks, jnp.asarray(logits))),
        R.categorical(jkey_to_torch(ks), torch.from_numpy(logits)).numpy())
    ks2 = jax.random.split(jax.random.PRNGKey(4), n * s).reshape(n, s, 2)
    flat = logits.reshape(n, s, a)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jax.vmap(jax.vmap(jax.random.categorical)))(
            ks2, jnp.asarray(flat))),
        R.categorical(jkey_to_torch(ks2), torch.from_numpy(flat)).numpy())


def test_normal_follows_reference_construction():
    """Port-native init draws: the reference's construction, torch's
    erfinv — close, not bitwise."""
    k, tk = jax.random.PRNGKey(0), R.key(0)
    np.testing.assert_allclose(np.asarray(jax.random.normal(k, (512,))),
                               R.normal(tk, (512,)).numpy(), atol=1e-5)
    tn = R.truncated_normal(tk, -2.0, 2.0, (512,)).numpy()
    np.testing.assert_allclose(
        np.asarray(jax.random.truncated_normal(k, -2.0, 2.0, (512,))), tn,
        atol=1e-5)
    assert np.abs(tn).max() <= 2.0
