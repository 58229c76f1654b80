"""The port's synthetic LM data (``repro_torch.data.{synthetic,pipeline}``
and ``repro_torch.random.categorical(shape=)``) against the reference
(``repro.data``, ``jax.random``).

Token batches bit for bit, at vocab 256 and 32,000, over several (seed,
step), through ``lm_iterator`` and resumed from ``start_step``.
``zipf_logits`` within two float32 ulps: XLA's CPU ``log`` is not
correctly rounded (it differs from the float64 log rounded to float32 on
308 of the 32,000 ranks, by one ulp; torch's ``log`` differs on none),
and the product with -1.1 may carry that to two. A token would change
only where a row's top two Gumbel-perturbed logits lie within such a
difference of each other, which none of the batches here reaches.
``frames`` and ``patches`` within 1e-5 in float32 (the port's ``normal``
uses torch's ``erfinv``, close to jax's, not equal) and one bf16 rounding
step (2^-7 relative) after the cast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch import random as R
from repro_torch.data import pipeline, synthetic


def jbatch_np(b):
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("vocab", [256, 32_000])
def test_lm_batch_bit_for_bit(vocab):
    for seed in (0, 7):
        for step in (0, 1, 13):
            want = jbatch_np(jsyn.lm_batch(
                jax.random.fold_in(jax.random.PRNGKey(seed), step), 3, 33,
                vocab))
            got = synthetic.lm_batch(R.fold_in(R.key(seed), step), 3, 33,
                                     vocab)
            for k in ("tokens", "labels"):
                assert got[k].shape == (3, 33)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
            np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                          got["labels"][:, :-1].numpy())


def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_zipf_logits_within_two_ulps():
    """The logs of the ranks within an ulp of XLA's, the logits (times
    -1.1) within two."""
    ranks = np.arange(1, 32_001, dtype=np.float32)
    assert ulps(torch.log(torch.from_numpy(ranks)).numpy(),
                np.asarray(jnp.log(ranks))).max() <= 1
    assert ulps(synthetic.zipf_logits(32_000).numpy(),
                np.asarray(jsyn.zipf_logits(32_000))).max() <= 2


def test_categorical_shape_draws_in_blocks(monkeypatch):
    """``categorical(key, logits, shape=)`` equals jax's at any block
    size: each element's bits depend only on its flat index."""
    logits = synthetic.zipf_logits(50)[None, None]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.categorical(
        key, jnp.asarray(logits.numpy()), shape=(4, 9)))
    for block in (1, 7 * 50, 1 << 24):
        monkeypatch.setattr(R, "_DRAW_BLOCK", block)
        got = R.categorical(R.key(3), logits, shape=(4, 9))
        np.testing.assert_array_equal(got.numpy(), want)


def test_lm_iterator_and_restart():
    """Batch ``step`` depends only on (seed, step): the iterator equals the
    reference's, and one started at step 2 equals the rest of it."""
    ref = jpipe.lm_iterator(seed=5, batch=2, seq=16, vocab=256)
    want = [jbatch_np(next(ref)) for _ in range(4)]
    it = pipeline.lm_iterator(5, 2, 16, 256, device="cpu")
    got = [next(it) for _ in range(4)]
    resumed = pipeline.lm_iterator(5, 2, 16, 256, start_step=2,
                                   device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    for g in (next(resumed), next(resumed)):
        w = want.pop(2)
        np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(pipeline.lm_iterator(5, 2, 16, 256))


def test_with_extras_and_shard_batch():
    it = pipeline.with_extras(
        pipeline.lm_iterator(0, 2, 8, 64, device="cpu"),
        lambda step: {"step": torch.tensor(step)}, start_step=3)
    assert [int(next(it)["step"]) for _ in range(2)] == [3, 4]
    # shard_batch lays each leaf out over the batch axes of the mesh: on
    # the host mesh (data=1, model=1) the one rank holds the whole batch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import bootstrap
    from repro_torch.launch import mesh as launch_mesh
    batch = next(pipeline.lm_iterator(0, 2, 8, 64, device="cpu"))
    try:
        placed = pipeline.shard_batch(batch, launch_mesh.make_host_mesh(
            device_type="cpu"))
        for name, x in placed.items():
            assert x.placements == (Shard(0), Replicate())
            assert torch.equal(x.full_tensor(), batch[name])
    finally:
        bootstrap.release_solo_group()


@pytest.mark.parametrize("name,shape", [("frames", (2, 12, 8)),
                                        ("patches", (2, 5, 16))])
def test_frames_and_patches_match_reference(name, shape):
    key = jax.random.PRNGKey(11)
    want32 = np.asarray(getattr(jsyn, name)(key, *shape, jnp.float32))
    got32 = getattr(synthetic, name)(R.key(11), *shape, torch.float32)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=0, atol=1e-5)
    want = np.asarray(getattr(jsyn, name)(key, *shape).astype(jnp.float32))
    got = getattr(synthetic, name)(R.key(11), *shape)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-5)
