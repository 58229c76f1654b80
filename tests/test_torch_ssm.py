"""``repro_torch.nn.ssm`` and the SSD op's CPU path against the reference
(``repro.nn.ssm``, ``repro.kernels.ssd``): the same numpy inputs (and the
reference's own parameters, carried across) through both.

Tolerances (|err| <= tol + tol·|reference|): the conv 1e-6; the SSD scan,
the plain intra-chunk block and the op 2e-4, the reference's own
kernel-against-oracle tolerance (``tests/test_kernels.py``); the layer and
its decode 1e-4 in float32 (a matmul, a norm and a gate around the scan),
and 2e-2 times max(1, largest magnitude) in bfloat16 (each side rounds to
bf16 at the same points, a rounding flip costs 2^-8 relative). The bf16
tensor-core kernel's roundings, emulated here, hold the reference kernel's
bf16 outputs within 1e-2 times max(1, largest magnitude) for y (two bf16
roundings of 2^-8) and 2e-4 for the f32 states and decay. The CUDA
kernel itself is held to its plain version on the card by
``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_close_scaled, to_torch, tree_maxdiff
from repro.kernels.ssd import kernel as jssd_kernel
from repro.kernels.ssd import ops as jssd_ops
from repro.nn import ssm as jssm
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.nn import ssm as tssm
from repro_torch.tree import leaves

SSD_TOL, LAYER_TOL, BF16_TOL = 2e-4, 1e-4, 2e-2
BF16_Y_TOL = 1e-2      # a bf16 output of the SSD block (test_torch_cuda.py)


def assert_close(actual, desired, tol):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               atol=tol, rtol=tol)


def ssd_inputs(seed, b, t, h, p, n, with_state=False):
    """numpy inputs in the reference test's distribution."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, h, p).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(b, t, h))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = rng.randn(b, t, n).astype(np.float32)
    c = rng.randn(b, t, n).astype(np.float32)
    s0 = rng.randn(b, h, p, n).astype(np.float32) if with_state else None
    return x, dt, a, bm, c, s0


def both(arrs):
    return ([None if x is None else jnp.asarray(x) for x in arrs],
            [None if x is None else torch.from_numpy(x) for x in arrs])


def test_causal_conv1d_matches_reference():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(2, 11, 6).astype(np.float32),
               rng.randn(4, 6).astype(np.float32),
               rng.randn(6).astype(np.float32))
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv1d(*(torch.from_numpy(v) for v in (x, w, b)))
    assert_close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    (jx, jdt, ja, jb, jc, js0), (tx, tdt, ta, tb, tc, ts0) = both(
        ssd_inputs(1, 2, 128, 3, 16, 16, with_state))
    want = jssm.ssd_chunked(jx, jdt, ja, jb, jc, chunk=32, initial_state=js0)
    got = tssm.ssd_chunked(tx, tdt, ta, tb, tc, chunk=32, initial_state=ts0)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w, SSD_TOL)


def test_plain_intra_chunk_matches_reference_kernel():
    """The plain version the CUDA kernel is held to, against the
    reference's Pallas kernel (interpret mode): all three outputs."""
    x, dt, a, bm, c, _ = ssd_inputs(2, 2, 128, 4, 16, 32)
    la = dt * a[None, None, :]
    xw = x * dt[..., None]
    want = jssd_kernel.ssd_intra_chunk(*(jnp.asarray(v) for v in
                                         (xw, la, bm, c)),
                                       chunk=32, interpret=True)
    got = ssd_ref.intra_chunk(*(torch.from_numpy(v) for v in
                                (xw, la, bm, c)), chunk=32)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g.numpy(), w, SSD_TOL)


def _sm90_roundings(xw, la, b, c, *, chunk):
    """The tensor-core kernel's arithmetic (``csrc/ssd_sm90.cu``) in torch
    on the CPU: C, B and X taken as bf16 with exact products summed in
    f32; M and X·w each split into bf16 hi + lo; y rounded to bf16."""
    bsz, t, h, p = xw.shape
    n = b.shape[-1]
    nc = t // chunk
    split = lambda v: (v.bfloat16().float(),
                       (v - v.bfloat16().float()).bfloat16().float())
    x = xw.reshape(bsz, nc, chunk, h, p).float()
    lac = torch.movedim(la.reshape(bsz, nc, chunk, h).float(), -1, 2)
    bc = b.reshape(bsz, nc, chunk, n).float()
    cc = c.reshape(bsz, nc, chunk, n).float()
    cs = torch.cumsum(lac, dim=-1)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    m = torch.where(tri, torch.einsum("bcin,bcjn->bcij", cc, bc)[:, :, None]
                    * torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    y = sum(torch.einsum("bchij,bcjhp->bcihp", part, x) for part in split(m))
    xw_w = x * torch.movedim(torch.exp(cs[..., -1:] - cs), 2, 3)[..., None]
    states = sum(torch.einsum("bcjhp,bcjn->bchpn", part, bc)
                 for part in split(xw_w))
    return (y.reshape(bsz, t, h, p).bfloat16(), states,
            torch.exp(cs[..., -1]))


def test_sm90_roundings_hold_reference_kernel():
    """The precision design of the bf16 tensor-core kernel, checked before
    the card does: its roundings, emulated in torch, against the
    reference's Pallas kernel (interpret mode) on the same bf16 inputs at
    mamba2's head and state widths; y within the bf16 limit, the f32
    states and decay within 2e-4."""
    x, dt, a, bm, c, _ = ssd_inputs(6, 1, 256, 4, 64, 128)
    la = (dt * a[None, None, :]).astype(np.float32)
    bf = lambda v: torch.from_numpy(v).bfloat16()
    txw, tb, tc = bf(x * dt[..., None]), bf(bm), bf(c)
    jb = lambda v: jnp.asarray(v.float().numpy(), jnp.bfloat16)
    want = jssd_kernel.ssd_intra_chunk(jb(txw), jnp.asarray(la), jb(tb),
                                       jb(tc), chunk=128, interpret=True)
    got = _sm90_roundings(txw, torch.from_numpy(la), tb, tc, chunk=128)
    assert got[0].dtype == torch.bfloat16
    assert_close_scaled(got[0].float().numpy(),
                        np.asarray(want[0].astype(jnp.float32)), BF16_Y_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        assert_close(g.numpy(), w, SSD_TOL)


@pytest.mark.parametrize("b,t,h,p,n,chunk,with_state", [
    # the reference's kernel test shapes (tests/test_kernels.py)
    (1, 128, 2, 16, 16, 32, False), (2, 256, 4, 32, 32, 64, False),
    (1, 64, 1, 8, 64, 64, False), (1, 64, 2, 8, 16, 32, True)])
def test_ssd_op_cpu_path_matches_reference_kernel(b, t, h, p, n, chunk,
                                                  with_state):
    (jx, jdt, ja, jb, jc, js0), (tx, tdt, ta, tb, tc, ts0) = both(
        ssd_inputs(3, b, t, h, p, n, with_state))
    want = jssd_ops.ssd(jx, jdt, ja, jb, jc, chunk=chunk, initial_state=js0,
                        interpret=True)
    before = ssd_kernel.LAUNCHES["ssd_intra_chunk"]
    got = ssd_ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, initial_state=ts0)
    assert ssd_kernel.LAUNCHES["ssd_intra_chunk"] == before  # none on CPU
    for g, w in zip(got, want):
        assert_close(g.numpy(), w, SSD_TOL)


def _cfgs(dtype):
    """mamba2-780m's SSM layer cut to d_model 64 (the reduced config's
    widths: state 16, head_dim 16, chunk 16), on both sides."""
    j = jssm.SSMConfig(d_model=64, state=16, head_dim=16, chunk=16,
                       dtype=jnp.float32 if dtype == "float32"
                       else jnp.bfloat16)
    t = tssm.SSMConfig(d_model=64, state=16, head_dim=16, chunk=16,
                       dtype=torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    return j, t


def _layer_inputs(jcfg, dtype, b=2, t=64, seed=4):
    params = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    # non-zero conv bias and skip so every term is exercised
    params = dict(params, conv_b=(0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["conv_b"].shape)).astype(
        params["conv_b"].dtype))
    x = np.random.RandomState(seed).randn(b, t, jcfg.d_model).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "float32"
                                else torch.bfloat16)
    return params, jx, tx


def _assert_dtype_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        assert_close(got, want, LAYER_TOL)
    else:
        assert_close_scaled(got, want, BF16_TOL)


def test_ssm_init_matches_reference_tree():
    """The port's own init: the reference's tree, shapes and dtypes, and
    its values for the deterministic leaves."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    tp = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    jl, tl = jax.tree.leaves(jp), leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        assert_close(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                     1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_layer_matches_reference(dtype, use_kernel):
    """``ssm_layer`` with the reference's parameters; ``use_kernel=True``
    on both sides (the reference's Pallas kernel in interpret mode, the
    port's kernel op over its plain version on the CPU)."""
    jcfg, tcfg = _cfgs(dtype)
    params, jx, tx = _layer_inputs(jcfg, dtype)
    want = jax.jit(lambda p, x: jssm.ssm_layer(
        p, x, jcfg, use_kernel=use_kernel))(params, jx)
    got = tssm.ssm_layer(to_torch(params), tx, tcfg, use_kernel=use_kernel)
    assert got.dtype == tx.dtype
    _assert_dtype_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(dtype):
    """12 one-token steps: outputs and the carried conv window and state."""
    jcfg, tcfg = _cfgs(dtype)
    params, jx, tx = _layer_inputs(jcfg, dtype, t=12)
    tparams = to_torch(params)
    jcache = jssm.init_ssm_cache(jcfg, 2)
    tcache = tssm.init_ssm_cache(tcfg, 2)
    step = jax.jit(lambda p, x, c: jssm.ssm_decode_step(p, x, c, jcfg))
    for i in range(12):
        want, jcache = step(params, jx[:, i:i + 1], jcache)
        got, tcache = tssm.ssm_decode_step(tparams, tx[:, i:i + 1], tcache,
                                           tcfg)
        _assert_dtype_close(got, want, dtype)
    assert tree_maxdiff(tcache, jcache) <= (
        LAYER_TOL if dtype == "float32" else BF16_TOL) * max(
        1.0, float(np.abs(np.asarray(jcache["state"])).max()))


def test_ssm_decode_continues_the_prefill():
    """The recurrent form continues the chunked form: the port's decode
    over the last steps equals the port's layer over the whole prompt."""
    _, tcfg = _cfgs("float32")
    jcfg, _ = _cfgs("float32")
    params, _, tx = _layer_inputs(jcfg, "float32", t=32)
    tparams = to_torch(params)
    full = tssm.ssm_layer(tparams, tx, tcfg)
    cache = tssm.init_ssm_cache(tcfg, 2)
    outs = []
    for i in range(32):
        y, cache = tssm.ssm_decode_step(tparams, tx[:, i:i + 1], cache, tcfg)
        outs.append(y)
    assert_close(torch.cat(outs, 1).numpy(), full.numpy(), LAYER_TOL)


def test_ssd_kernel_refuses_cpu_tensors():
    xw = torch.zeros(1, 64, 2, 8)
    la = torch.zeros(1, 64, 2)
    bm = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_kernel.forward(xw, la, bm, bm, chunk=32)


def test_ssm_config_matches_reference():
    jcfg, tcfg = _cfgs("float32")
    jf = dataclasses.asdict(jcfg)
    tf = dataclasses.asdict(tcfg)
    jf.pop("dtype"), tf.pop("dtype")
    assert jf == tf
    assert (tcfg.d_inner, tcfg.num_heads) == (jcfg.d_inner, jcfg.num_heads)
