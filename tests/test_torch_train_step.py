"""The port's train step (``repro_torch.launch.steps.make_train_step``)
against the same step composed from the reference's pieces, on reduced
tinyllama in float32 with the reference's weights and batches.

The reference's own ``make_train_step`` tests are red under jax 0.9.0
(ROADMAP queue 3), so the reference side here is its pieces in the order
its step runs them: ``jax.value_and_grad(api.loss_fn(spec))`` (over
microbatch slices of the batch axis with fp32 accumulation, loss and
metrics summed, all scaled by 1/m, as its ``grads_of``), ``sanitize``,
``clip_by_global_norm``, ``adamw.update`` at ``warmup_cosine(peak, 2000,
100000)(step)`` and ``cast_like``. The peak learning rate is 100, so the
warmup's lr (peak·step/2000: 0, 0.05, 0.1) moves the weights visibly.

Tolerances: 1e-4 on the loss, metrics and grad norm (relative) and on
every leaf of the params, master, mu and nu (of the leaf's largest
magnitude) after each of three steps; microbatches 2 and 4 against 1
inside the port likewise. The three remat modes give the same loss and
gradients bit for bit (recompute changes no number).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import (assert_leaves_close, np_leaves, train_batch,
                           train_params, train_specs)
from repro.configs import shapes as jshapes
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedule as jsched
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.tree import leaves

ARCH = "tinyllama-1.1b"
TOL = 1e-4
PEAK = 100.0
B, T, STEPS = 4, 32, 3


def reference_step(spec, microbatches):
    """The reference's train step, composed from its pieces."""
    loss_fn = japi.loss_fn(spec)
    lr_fn = jsched.warmup_cosine(PEAK, 2_000, 100_000)
    vg = jax.value_and_grad(loss_fn, has_aux=True)

    def grads_of(params, batch):
        if microbatches == 1:
            return vg(params, batch)
        split = jax.tree.map(lambda x: x.reshape(
            (microbatches, x.shape[0] // microbatches) + x.shape[1:]), batch)
        g = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        loss, metrics = jnp.zeros((), jnp.float32), None
        for i in range(microbatches):
            (l_, m_), g_ = vg(params, jax.tree.map(lambda x: x[i], split))
            g = jax.tree.map(jnp.add, g, g_)
            loss = loss + l_
            metrics = m_ if metrics is None else jax.tree.map(jnp.add,
                                                              metrics, m_)
        s = 1.0 / microbatches
        return (loss * s, jax.tree.map(lambda x: x * s, metrics)), \
            jax.tree.map(lambda x: x * s, g)

    @jax.jit
    def step(params, opt, batch):
        (loss, metrics), grads = grads_of(params, batch)
        grads = jclip.sanitize(grads)
        grads, gnorm = jclip.clip_by_global_norm(grads, 1.0)
        master, opt = jadamw.update(grads, opt, lr_fn(opt["step"]))
        return jadamw.cast_like(master, params), opt, \
            {**metrics, "loss": loss, "grad_norm": gnorm}

    return step


def batches(spec):
    return [train_batch(spec, B, T, seed=10 + i) for i in range(STEPS)]


def run_port(ts, tp, tbatches, microbatches, **kw):
    step = steps.make_train_step(ts, peak_lr=PEAK,
                                 microbatches=microbatches, **kw)
    params, opt = tp, adamw.init(tp, per_agent=False)
    out = []
    for b in tbatches:
        params, opt, metrics = step(params, opt, b)
        out.append((params, opt, metrics))
    return out


def assert_step_close(got, want):
    (gp, go, gm), (wp, wo, wm) = got, want
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=TOL,
                                   atol=1e-7)
    assert int(go["step"]) == int(wo["step"])
    assert_leaves_close(gp, wp, TOL)
    for k in ("master", "mu", "nu"):
        assert_leaves_close(go[k], wo[k], TOL)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_three_steps_match_reference_composed_step(microbatches):
    js, ts = train_specs(ARCH)
    jp, tp = train_params(ARCH)
    bs = batches(js)
    ref = reference_step(js, microbatches)
    params, opt = jp, jadamw.init(jp)
    want = []
    for jb, _ in bs:
        params, opt, metrics = ref(params, opt, jb)
        want.append((params, opt, metrics))
    got = run_port(ts, tp, [tb for _, tb in bs], microbatches)
    for g, w in zip(got, want):
        assert_step_close(g, w)
    # the first step's lr is 0: only mu and nu moved
    np.testing.assert_array_equal(np_leaves(got[0][1]["master"])[0],
                                  np_leaves(tp)[0])
    assert int(got[-1][1]["step"]) == STEPS
    assert float(got[-1][2]["grad_norm"]) > 0


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatches_match_monolithic(microbatches):
    """Inside the port: the accumulated step against the monolithic one
    (in float32 the accumulation's fp32 and the grads' dtype agree)."""
    _, ts = train_specs(ARCH)
    _, tp = train_params(ARCH)
    tbs = [tb for _, tb in batches(train_specs(ARCH)[0])]
    for g, w in zip(run_port(ts, tp, tbs, microbatches),
                    run_port(ts, tp, tbs, 1)):
        assert_step_close(g, w)


def test_microbatches_must_divide_the_batch():
    _, ts = train_specs(ARCH)
    _, tp = train_params(ARCH)
    with pytest.raises(AssertionError):
        steps.make_train_step(ts, jshapes.REDUCED_SHAPES["train_4k"],
                              microbatches=3)
    step = steps.make_train_step(ts, microbatches=3)
    _, tb = train_batch(train_specs(ARCH)[0], B, T)
    with pytest.raises(AssertionError):
        step(tp, adamw.init(tp, per_agent=False), tb)


def test_bf16_microbatches_accumulate_in_fp32():
    """In bf16 the accumulated step clips and updates fp32 gradients, the
    monolithic one bf16 gradients, as in the reference: both steps run,
    finite, and their losses agree to bf16 rounding."""
    _, ts = train_specs(ARCH, "bfloat16")
    _, tp = train_params(ARCH, "bfloat16")
    _, tb = train_batch(train_specs(ARCH, "bfloat16")[0], B, T)
    seen = {}
    real = adamw.update

    def spy(grads, state, lr, cfg=adamw.AdamWConfig()):
        seen.setdefault("dtypes", []).append(
            {g.dtype for g in leaves(grads)})
        return real(grads, state, lr, cfg)

    adamw.update = spy
    try:
        out = {m: run_port(ts, tp, [tb], m)[0] for m in (1, 2)}
    finally:
        adamw.update = real
    assert seen["dtypes"][0] == {torch.bfloat16, torch.float32}
    assert seen["dtypes"][1] == {torch.float32}
    for _, opt, metrics in out.values():
        assert all(bool(torch.isfinite(x).all()) for x in leaves(opt))
    np.testing.assert_allclose(float(out[2][2]["loss"]),
                               float(out[1][2]["loss"]), rtol=1e-2)


def test_remat_modes_give_equal_loss_and_grads():
    _, ts = train_specs(ARCH)
    _, tp = train_params(ARCH)
    _, tb = train_batch(train_specs(ARCH)[0], B, T)
    out = {}
    for mode in ("none", "full", "dots"):
        spec = dataclasses.replace(ts, cfg=dataclasses.replace(
            ts.cfg, remat=mode))
        out[mode] = steps.make_value_and_grad(api.loss_fn(spec))(tp, tb)
    (l0, m0), g0 = out["none"]
    for mode in ("full", "dots"):
        (l1, m1), g1 = out[mode]
        assert torch.equal(l0, l1)
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    with pytest.raises(ValueError, match="remat"):
        spec = dataclasses.replace(ts, cfg=dataclasses.replace(
            ts.cfg, remat="some"))
        steps.make_value_and_grad(api.loss_fn(spec))(tp, tb)


def test_flash_under_autograd_raises():
    """The flash kernel is forward-only, as the reference's: training with
    ``use_flash=True`` raises instead of running attention without a
    gradient; the prefill with it still runs."""
    _, ts = train_specs(ARCH, use_flash=True)
    _, tp = train_params(ARCH)
    _, tb = train_batch(train_specs(ARCH)[0], B, T)
    with pytest.raises(NotImplementedError, match="forward-only"):
        steps.make_train_step(ts)(tp, adamw.init(tp, per_agent=False), tb)
    logits = steps.make_prefill_step(ts)(tp, {"tokens": tb["tokens"]})
    assert logits.shape == (B, 1, ts.cfg.vocab)
