"""The port's LM optimiser pieces (``repro_torch.optim.{clip,adamw,
schedule,compress,outer}``) against the reference (``repro.optim``) on
the same numpy inputs from a seed.

Tolerances: ``sanitize`` and the int8 ``q`` of ``compress`` bit for bit
(``torch.round`` and ``jnp.round`` both round half to even); the
compression's ``scale`` and error within 1e-7 absolute (float32 values of
magnitude <= 1, a few roundings); the clip, AdamW, the schedules and the
outer step within 1e-6 times max(1, largest magnitude) (the same float32
formulas; XLA's and torch's ``sqrt``, ``cos`` and ``pow`` may differ by
an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close_scaled, assert_tree_equal,
                           np_leaves, to_np, to_torch)
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import compress as jcomp
from repro.optim import outer as jouter
from repro.optim import schedule as jsched
from repro_torch.optim import adamw, clip, compress, outer, schedule

TOL = 1e-6


def lm_tree(seed=0, scale=1.0):
    """An LM-shaped tree: a stacked (repeats, d) norm scale (rank 2, so
    the reference decays it), a stacked matrix, a vector and a scalar."""
    rs = np.random.RandomState(seed)
    f = lambda *s: np.asarray(scale * rs.randn(*s), np.float32)
    return {"embed": {"table": f(11, 6)},
            "layers": [{"norm1": {"scale": f(3, 6)}, "w": f(3, 6, 5)}],
            "final_norm": {"scale": f(6)}, "gate": f()}


def close(got, want, tol=TOL):
    for g, w in zip(np_leaves(got), np_leaves(want)):
        assert_close_scaled(g, w, tol)


def test_sanitize_zeroes_non_finite_bit_for_bit():
    tree = lm_tree(1)
    tree["embed"]["table"][0, :3] = [np.nan, np.inf, -np.inf]
    tree["layers"][0]["w"][1, 2, 4] = np.nan
    bf = jnp.asarray(tree["layers"][0]["norm1"]["scale"]).astype(jnp.bfloat16)
    bf = bf.at[0, 0].set(jnp.inf)
    tree["bf16"] = np.asarray(bf)
    want = jclip.sanitize(jax.tree.map(jnp.asarray, tree))
    got = clip.sanitize(to_torch(tree))
    assert got["bf16"].dtype == torch.bfloat16
    assert_tree_equal(to_np(got), want)
    assert np.isfinite(np.concatenate([x.ravel() for x in np_leaves(got)])
                       ).all()


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_agentless_clip_matches_reference(max_norm):
    """One norm over the whole tree (clipping at 0.5; untouched at 1e3),
    a bf16 leaf cast back to bf16."""
    tree = lm_tree(2)
    tree["bf16"] = np.asarray(jnp.asarray(lm_tree(3)["embed"]["table"])
                              .astype(jnp.bfloat16))
    want, wnorm = jclip.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    got, gnorm = clip.clip_by_global_norm(to_torch(tree), max_norm,
                                          per_agent=False)
    assert gnorm.shape == () and got["bf16"].dtype == torch.bfloat16
    assert_close_scaled(gnorm.numpy(), wnorm, TOL)
    assert_close_scaled(clip.global_norm(to_torch(tree), per_agent=False)
                        .numpy(), jclip.global_norm(tree), TOL)
    close(got, want)


def test_per_agent_clip_keeps_its_default():
    """The DIALS callers' form is the default: one norm per leading row."""
    tree = {"w": torch.randn(3, 4, 5), "b": torch.randn(3, 5)}
    norm = clip.global_norm(tree)
    assert norm.shape == (3,)
    want = torch.sqrt(sum(torch.square(x[1]).sum() for x in tree.values()))
    assert torch.allclose(norm[1], want)


def test_lm_adamw_matches_reference_and_decays_stacked_norms():
    """Three LM-form updates (0-d step; decay on every leaf of rank >= 2,
    the stacked (repeats, d) norm scale included) against the
    reference's, and the per-agent form unchanged beside it."""
    params = lm_tree(4)
    cfg_j, cfg_t = jadamw.AdamWConfig(), adamw.AdamWConfig()
    jst = jadamw.init(jax.tree.map(jnp.asarray, params))
    tst = adamw.init(to_torch(params), per_agent=False)
    assert tst["step"].shape == () and tst["step"].dtype == torch.int64
    for i in range(3):
        g = lm_tree(10 + i, scale=0.3)
        jm, jst = jadamw.update(jax.tree.map(jnp.asarray, g), jst, 1e-2,
                                cfg_j)
        tm, tst = adamw.update(to_torch(g), tst, torch.tensor(1e-2), cfg_t)
        close(tm, jm)
        for k in ("mu", "nu"):
            close(tst[k], jst[k])
    assert int(tst["step"]) == 3
    # decay reached the stacked norm scale: with a zero gradient its
    # master still moves, by lr * wd * m
    zero = jax.tree.map(np.zeros_like, params)
    st = adamw.init(to_torch(params), per_agent=False)
    m, _ = adamw.update(to_torch(zero), st, 1e-2)
    scale = params["layers"][0]["norm1"]["scale"]
    np.testing.assert_allclose(m["layers"][0]["norm1"]["scale"].numpy(),
                               scale - 1e-2 * 0.1 * scale, rtol=1e-6)
    np.testing.assert_array_equal(m["final_norm"]["scale"].numpy(),
                                  params["final_norm"]["scale"])
    # the per-agent form: step (A,), a (A, d) leaf is per-agent rank 1
    pa = adamw.init({"b": torch.ones(3, 4)})
    assert pa["step"].shape == (3,)
    m, _ = adamw.update({"b": torch.zeros(3, 4)}, pa, 1e-2)
    assert torch.equal(m["b"], torch.ones(3, 4))


@pytest.mark.parametrize("name", ["constant", "warmup_cosine",
                                  "warmup_linear"])
def test_schedules_match_reference(name):
    warmup, total = 20, 100
    args = (3e-4,) if name == "constant" else (3e-4, warmup, total)
    kw = {} if name == "constant" else {"floor": 1e-5}
    jf = getattr(jsched, name)(*args, **kw)
    tf = getattr(schedule, name)(*args, **kw)
    for step in (0, 1, warmup - 1, warmup, (warmup + total) // 2, total,
                 total + 5):
        got = tf(torch.tensor(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert_close_scaled(got.numpy(), jf(step), TOL)
        assert_close_scaled(tf(step).numpy(), jf(step), TOL)
    assert float(schedule.warmup_cosine(3e-4, 2000, 100000)(0)) == 0.0


@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (3, 4, 6)])
def test_compress_matches_reference(shape):
    rs = np.random.RandomState(len(shape))
    x = np.asarray(rs.randn(*shape), np.float32)
    err = np.asarray(1e-3 * rs.randn(*shape), np.float32)
    jq, js, je = jcomp.compress(jnp.asarray(x), jnp.asarray(err))
    tq, ts, te = compress.compress(torch.from_numpy(x), torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-7)
    back = compress.decompress(tq, ts, x.shape)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jcomp.decompress(jq, js, x.shape)),
        rtol=0, atol=1e-7)


def test_tree_compress_round_trip_matches_reference():
    tree = lm_tree(5)
    jt = jax.tree.map(jnp.asarray, tree)
    jerr = jcomp.init_error(jt)
    terr = compress.init_error(to_torch(tree))
    jq, js, je = jcomp.tree_compress(jt, jerr)
    tq, ts, te = compress.tree_compress(to_torch(tree), terr)
    assert_tree_equal(to_np(tq), jq)
    for got, want in ((ts, js), (te, je),
                      (compress.tree_decompress(tq, ts, to_torch(tree)),
                       jcomp.tree_decompress(jq, js, jt))):
        for g, w in zip(np_leaves(got), np_leaves(want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("int8", [True, False])
def test_outer_step_matches_reference(int8, nesterov):
    """Three reconciliations with pod_axis=None: the anchor, velocity,
    new params and the error feedback carried across them."""
    cfg_j = jouter.OuterConfig(compress_int8=int8, nesterov=nesterov)
    cfg_t = outer.OuterConfig(compress_int8=int8, nesterov=nesterov)
    params = lm_tree(6)
    jst = jouter.init(jax.tree.map(jnp.asarray, params))
    tst = outer.init(to_torch(params))
    jerr = terr = None
    for i in range(3):
        local = jax.tree.map(lambda a, d: a + d, params,
                             lm_tree(20 + i, scale=0.05))
        jp, jst, jerr = jouter.outer_step(jax.tree.map(jnp.asarray, local),
                                          jst, cfg_j, err_tree=jerr)
        tp, tst, terr = outer.outer_step(to_torch(local), tst, cfg_t,
                                         err_tree=terr)
        close(tp, jp)
        close(tst, jst)
        assert (terr is None) == (jerr is None) == (not int8)
        if int8:
            close(terr, jerr)
        params = to_np(tp)
