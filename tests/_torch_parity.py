"""Helpers of the port's parity tests (``tests/test_torch_*.py``): move
pytrees between the JAX package and the port, and compare them.

The same inputs, made with numpy from a seed or by the reference itself,
go through a JAX function and its ``repro_torch`` counterpart; JAX runs on
the CPU with ``use_kernels="off"`` (its own tests hold its Pallas kernels
to that oracle).
"""
import jax
import numpy as np
import torch

from repro_torch import convert

# The suite runs several test processes side by side; at these small
# sizes one intra-op thread each is enough, and more would take cores
# from the timing-sensitive multi-process tests running beside them.
torch.set_num_threads(1)


def to_torch(tree):
    """A JAX (or numpy) pytree -> the port's tensors on the CPU."""
    return convert.from_jax_params(jax.device_get(tree), "cpu")


def to_np(tree):
    return convert.to_numpy(tree)


def np_leaves(tree):
    """Leaves as numpy, in jax.tree order, from either side."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = to_np(tree)
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]


def tree_maxdiff(a, b) -> float:
    la, lb = np_leaves(a), np_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape, (x.shape, y.shape)
    return max(float(np.abs(x.astype(np.float64) - y.astype(np.float64))
                     .max()) for x, y in zip(la, lb))


def assert_close_scaled(actual, desired, tol: float):
    """max |actual - desired| <= tol * max(1, max |desired|): an absolute
    tolerance on tensors of magnitude <= 1, relative to the largest
    magnitude above that (sums over many terms carry rounding in
    proportion to their size)."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    err = float(np.abs(actual - desired).max())
    scale = max(1.0, float(np.abs(desired).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def assert_tree_equal(a, b):
    for x, y in zip(np_leaves(a), np_leaves(b)):
        np.testing.assert_array_equal(x.astype(np.int64)
                                      if x.dtype == np.uint32 else x,
                                      y.astype(np.int64)
                                      if y.dtype == np.uint32 else y)


def jkey_to_torch(key):
    return torch.tensor(np.asarray(key).astype(np.int64))
