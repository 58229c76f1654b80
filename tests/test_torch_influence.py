"""The port's AIPs (``repro_torch.core.influence``, GRU kind) against the
reference: ``aip_apply``/``aip_sequence``, ``sample_sources`` bits,
``train_aip`` params and loss within 1e-5, and ``eval_ce`` on both its
single-batch and its chunked path."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import jkey_to_torch, to_torch, tree_maxdiff
from repro.core import influence as jinf
from repro_torch.core import influence

AGENTS, F, M = 2, 10, 4


def _aip(seed=0, **kw):
    args = dict(kind="gru", hidden=(16,), gru_hidden=8, epochs=4, batch=3,
                lr=1e-3, **kw)
    jcfg = jinf.AIPConfig(F, M, use_kernels="off", **args)
    cfg = influence.AIPConfig(F, M, **args)
    params = jax.jit(jax.vmap(lambda k: jinf.aip_init(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(seed), AGENTS))
    return jcfg, cfg, jax.device_get(params)


def _data(s, t, seed=0):
    rng = np.random.RandomState(seed)
    return {"feats": rng.randn(AGENTS, s, t, F).astype(np.float32),
            "u": (rng.rand(AGENTS, s, t, M) < 0.3).astype(np.float32),
            "resets": (rng.rand(AGENTS, s, t) < 0.1).astype(np.float32)}


def test_aip_apply_sequence_and_sources_match():
    jcfg, cfg, params = _aip()
    data = _data(3, 6)
    h = np.zeros((AGENTS, 3, 8), np.float32)
    jl = jax.jit(jax.vmap(lambda p, f, r: jinf.aip_sequence(
        p, f, jinf.initial_hidden(jcfg, 3), r, jcfg)))(
        params, data["feats"], data["resets"])
    tl = influence.aip_sequence(to_torch(params), to_torch(data["feats"]),
                                torch.zeros(AGENTS, 3, 8),
                                to_torch(data["resets"]), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    feat = data["feats"][:, :, 0]
    jstep, jh = jax.jit(jax.vmap(
        lambda p, f, hh: jinf.aip_apply(p, f, hh, jcfg)))(params, feat, h)
    tstep, th = influence.aip_apply(to_torch(params), to_torch(feat),
                                    to_torch(h), cfg)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    keys = jax.random.split(jax.random.PRNGKey(8), AGENTS * 3).reshape(
        AGENTS, 3, 2)
    np.testing.assert_array_equal(
        influence.sample_sources(jkey_to_torch(keys), tstep).numpy(),
        np.asarray(jax.jit(jax.vmap(jax.vmap(jinf.sample_sources)))(
            keys, jstep)))


def test_train_aip_matches_reference():
    """Minibatch Adam over epochs with the wrap-around minibatches
    (S=7, batch 3): params and final loss within 1e-5."""
    jcfg, cfg, params = _aip(seed=1)
    data = _data(7, 9, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(21), AGENTS)
    jp, jloss = jax.jit(jax.vmap(lambda p, d, k: jinf.train_aip(
        p, d, k, jcfg)))(params, data, keys)
    tp, tloss = influence.train_aip(to_torch(params), to_torch(data),
                                    jkey_to_torch(keys), cfg)
    assert tree_maxdiff(jp, tp) < 1e-5
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=1e-5)
    jce = jax.vmap(lambda p, d: jinf.eval_ce(p, d, jcfg))(jp, data)
    np.testing.assert_allclose(influence.eval_ce(tp, to_torch(data),
                                                 cfg).numpy(),
                               np.asarray(jce), atol=1e-5)


@pytest.mark.parametrize("chunk", [64, 3])
def test_eval_ce_single_batch_and_chunked(chunk):
    jcfg, cfg, params = _aip(seed=2, eval_chunk=chunk)
    data = _data(8, 5, seed=2)
    jce = jax.jit(jax.vmap(lambda p, d: jinf.eval_ce(p, d, jcfg)))(params,
                                                                   data)
    tce = influence.eval_ce(to_torch(params), to_torch(data), cfg)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), atol=1e-6)


def test_epoch_minibatch_indices_wrap():
    perm = torch.tensor([[4, 2, 0, 1, 3]])
    idx = influence.epoch_minibatch_indices(perm, 2)
    assert idx.tolist() == [[[4, 2], [0, 1], [3, 4]]]
    np.testing.assert_array_equal(
        idx[0].numpy(), np.asarray(jinf.epoch_minibatch_indices(
            np.array([4, 2, 0, 1, 3]), 2)))
