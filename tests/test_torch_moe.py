"""The port's Mixture-of-Experts (``repro_torch.nn.moe``) against the
reference (``repro.nn.moe``), with the reference's ``moe_init`` parameters
carried across by ``convert``.

Routing is integer work on the same float32 router probabilities: the
chosen experts, their slot positions and the ``keep`` mask must match bit
for bit, on inputs where some (token, k) pairs are dropped. Tolerances
(|err| <= tol + tol·|reference|): float32 1e-4 on the layer output, the
top-k weights and the aux terms (the same f32 sums in another order).
bfloat16 5e-2 times max(1, largest magnitude): the expert products round
to bf16 at the same points on both sides, and one rounding flip of 2^-8
carries through the down projection.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_close_scaled, to_torch
from repro.nn import moe as jmoe
from repro_torch.nn import moe as tmoe

F32_TOL, BF16_TOL = 1e-4, 5e-2
D, F, E, K = 64, 64, 4, 2


def configs(dtype="float32", **kw):
    f32 = dtype == "float32"
    jc = jmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                        dtype=jnp.float32 if f32 else jnp.bfloat16, **kw)
    tc = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=K,
                        dtype=torch.float32 if f32 else torch.bfloat16, **kw)
    return jc, tc


def params_for(jc, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    return jp, to_torch(jp)


def jroute(jp, xj, jc):
    """The reference's ``_route``, compiled as one program (called op by
    op, each op compiles on its own: seconds a call)."""
    return jax.jit(lambda p, x: jmoe._route(p, x, jc))(jp, xj)


def inputs(shape, dtype="float32", seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    return xj, xt


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_dtype_close(got, want, dtype):
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert_close_scaled(got, want, BF16_TOL)


@pytest.mark.parametrize("tokens,factor", [(64, 1.25), (64, 0.5),
                                           (200, 1.0), (16, 1.25)])
def test_route_matches_reference_bit_for_bit(tokens, factor):
    """Experts, positions and keep bit for bit; the renormalised weights,
    the capacity and the aux terms within float32 tolerance."""
    jc, tc = configs(capacity_factor=factor)
    jp, tp = params_for(jc, seed=tokens)
    xj, xt = inputs((tokens, D), seed=tokens)
    jw, je, jpos, jkeep, jcap, jaux = jroute(jp, xj, jc)
    tw, te, tpos, tkeep, tcap, taux = tmoe._route(tp, xt, tc)
    assert tcap == jcap
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert_dtype_close(tw, jw, "float32")
    for name in ("load_balance", "z_loss"):
        assert_dtype_close(taux[name], jaux[name], "float32")
    if factor < 1.0 or tokens == 200:
        assert not bool(tkeep.all()), "no pair was dropped"


def test_route_matches_reference_at_granite_expert_counts():
    """32 experts, top 8 (granite-moe's router), 512 tokens: experts,
    positions and keep bit for bit."""
    kw = dict(d_model=128, d_ff=32, num_experts=32, top_k=8)
    jc, tc = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    jp, tp = params_for(jc, seed=5)
    xj, xt = inputs((512, 128), seed=5)
    jw, je, jpos, jkeep, jcap, _ = jroute(jp, xj, jc)
    tw, te, tpos, tkeep, tcap, _ = tmoe._route(tp, xt, tc)
    assert tcap == jcap
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert_dtype_close(tw, jw, "float32")


def test_route_ties_keep_the_lower_expert():
    """Equal router probabilities: both sides take the lower expert index
    first (``jax.lax.top_k``'s order), so positions agree too."""
    jc, tc = configs()
    jp, tp = params_for(jc)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 0]        # experts 0 and 2 always tie
    router[:, 3] = router[:, 1]        # and so do 1 and 3
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    xj, xt = inputs((40, D), seed=3)
    _, je, jpos, jkeep, _, _ = jroute(jp, xj, jc)
    _, te, tpos, tkeep, _, _ = tmoe._route(tp, xt, tc)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert set(np.unique(te.numpy()[:, 0])) <= {0, 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch,shape,factor", [
    ("dense", (2, 32, D), 1.25),
    ("dense", (2, 32, D), 0.5),          # drops
    ("gather", (2, 32, D), 1.25),        # 16 groups of 4 tokens
    ("gather", (2, 256, D), 0.5),        # 16 groups of 32, drops
    ("gather", (2, 9, D), 0.5),          # 18 tokens: one group, drops
])
def test_moe_layer_matches_reference(dtype, dispatch, shape, factor):
    """``moe_layer`` for both dispatches (the reference's dense one-hot
    einsums against the port's row scatter and gather), its output and
    aux terms."""
    jc, tc = configs(dtype, dispatch=dispatch, token_shards=16,
                     capacity_factor=factor)
    jp, tp = params_for(jc, seed=1)
    xj, xt = inputs(shape, dtype, seed=2)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_layer(p, x, jc))(jp, xj)
    ty, taux = tmoe.moe_layer(tp, xt, tc)
    assert ty.dtype == xt.dtype and tuple(ty.shape) == shape
    assert_dtype_close(ty, jy, dtype)
    for name in ("load_balance", "z_loss"):
        assert_dtype_close(taux[name], jaux[name], "float32")
    keep = tmoe.route_groups(tp, xt, tc)[3]
    groups = 16 if dispatch == "gather" and shape[0] * shape[1] % 16 == 0 \
        else 1
    assert keep.shape[0] == groups
    if factor < 1.0:
        assert not bool(keep.all()), "no pair was dropped"


def test_dropped_pairs_get_zero_weight():
    """A token whose every pair is dropped passes through as zeros (its
    residual carries it); the gather dispatch's groups route alone."""
    jc, tc = configs(capacity_factor=0.25)
    _, tp = params_for(jc, seed=4)
    _, xt = inputs((1, 64, D), seed=4)
    _, _, _, keep, _, _ = tmoe.route_groups(tp, xt, tc)
    y, _ = tmoe.moe_layer(tp, xt, tc)
    none_kept = ~keep[0].any(-1)
    assert bool(none_kept.any())
    assert float(y[0][none_kept].abs().max()) == 0.0


@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 64, 512, 8192, 8193])
@pytest.mark.parametrize("e,k,factor", [(4, 2, 1.25), (32, 8, 1.25),
                                        (16, 4, 1.0), (16, 4, 0.5)])
def test_capacity_matches_reference(tokens, e, k, factor):
    jc = jmoe.MoEConfig(d_model=8, d_ff=8, num_experts=e, top_k=k,
                        capacity_factor=factor)
    tc = tmoe.MoEConfig(**{f.name: getattr(jc, f.name)
                           for f in dataclasses.fields(jc)
                           if f.name != "dtype"})
    cap = tc.capacity(tokens)
    assert cap == jc.capacity(tokens)
    assert cap >= 8 and cap % 8 == 0


def test_param_tree_matches_reference():
    for act in ("swiglu", "gelu"):
        jc, tc = configs(activation=act)
        jp = jax.eval_shape(lambda k: jmoe.moe_init(k, jc),
                            jax.random.PRNGKey(0))
        tp = tmoe.moe_init(torch.Generator().manual_seed(0), tc)
        assert sorted(jp) == sorted(tp)
        for name in jp:
            assert tuple(jp[name].shape) == tuple(tp[name].shape)
            assert str(jp[name].dtype) == str(tp[name].dtype).replace(
                "torch.", "")
