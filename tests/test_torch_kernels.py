"""GRU and GAE in the port against the reference: the plain torch oracles
(``repro_torch.nn.gru``, ``repro_torch.marl.gae``) and the kernel ops'
CPU path (``repro_torch.kernels.*.ops`` over the kernels' plain
versions), forward and gradients, with resets and an agent axis; the
dispatch rules. The CUDA kernels themselves are held to their plain
versions on the card by ``test_torch_cuda.py``.

Tolerances: GRU 1e-5 and GAE 1e-6, absolute on tensors of magnitude
<= 1 and relative to the largest magnitude above that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_close_scaled, to_torch, tree_maxdiff
from repro.marl import gae as jgae
from repro.nn import gru as jgru
from repro_torch.kernels import dispatch
from repro_torch.kernels.gae import kernel as gae_kernel
from repro_torch.kernels.gae import ops as gae_ops
from repro_torch.kernels.gae import ref as gae_ref
from repro_torch.kernels.gru import kernel as gru_kernel
from repro_torch.kernels.gru import ops as gru_ops
from repro_torch.kernels.gru import ref as gru_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.marl import gae as tgae
from repro_torch.nn import gru as tgru

GRU_TOL, GAE_TOL = 1e-5, 1e-6


def _gru_case(a, b, t, din, h, seed=0):
    """Per-agent reference params and numpy inputs from one seed."""
    params = jax.jit(jax.vmap(lambda k: jgru.gru_init(
        k, jgru.GRUConfig(in_dim=din, hidden=h))))(
        jax.random.split(jax.random.PRNGKey(seed), a))
    params = jax.tree.map(np.asarray, params)
    # non-zero biases so their gradients are exercised
    rng = np.random.RandomState(seed)
    params["bi"] = (0.1 * rng.randn(a, 3 * h)).astype(np.float32)
    params["bh"] = (0.1 * rng.randn(a, 3 * h)).astype(np.float32)
    xs = rng.randn(a, b, t, din).astype(np.float32)
    h0 = (0.5 * rng.randn(a, b, h)).astype(np.float32)
    resets = (rng.rand(a, b, t) < 0.2).astype(np.float32)
    g = rng.randn(a, b, t, h).astype(np.float32)
    return params, xs, h0, resets, g


def _jax_seq_grads(params, xs, h0, resets, g):
    def loss(p, x, h0_, r, gg):
        hs, h_last = jgru.gru_sequence(p, x, h0_, reset_mask=r)
        return (hs * gg).sum() + (h_last ** 2).sum(), hs
    (_, hs), grads = jax.jit(jax.vmap(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)))(params, xs, h0, resets, g)
    return hs, grads


def _torch_seq_grads(seq_fn, params, xs, h0, resets, g):
    tp = to_torch(params)
    leaves = [tp["wi"], tp["wh"], tp["bi"], tp["bh"],
              torch.from_numpy(xs), torch.from_numpy(h0)]
    leaves = [x.clone().requires_grad_() for x in leaves]
    p = dict(zip(("wi", "wh", "bi", "bh"), leaves[:4]))
    hs, h_last = seq_fn(p, leaves[4], leaves[5], torch.from_numpy(resets))
    loss = (hs * torch.from_numpy(g)).sum() + (h_last ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    return hs, ({"bh": grads[3], "bi": grads[2], "wh": grads[1],
                 "wi": grads[0]}, grads[4], grads[5])


SEQ_FNS = {
    "oracle": lambda p, x, h0, r: tgru.gru_sequence(p, x, h0, reset_mask=r),
    "kernel_ops": lambda p, x, h0, r: gru_ops.gru_sequence(p, x, h0,
                                                           reset_mask=r),
}


@pytest.mark.parametrize("path", sorted(SEQ_FNS))
@pytest.mark.parametrize("a,b,t,din,h", [(1, 2, 16, 8, 16),
                                         (3, 4, 33, 12, 32),
                                         (1, 2, 9, 8, 128)])
def test_gru_sequence_and_grads_match_reference(path, a, b, t, din, h):
    params, xs, h0, resets, g = _gru_case(a, b, t, din, h)
    jhs, jgrads = _jax_seq_grads(params, xs, h0, resets, g)
    ths, tgrads = _torch_seq_grads(SEQ_FNS[path], params, xs, h0, resets, g)
    np.testing.assert_allclose(ths.detach().numpy(), np.asarray(jhs),
                               atol=GRU_TOL, rtol=GRU_TOL)
    assert tree_maxdiff(jgrads, tgrads) < GRU_TOL


@pytest.mark.parametrize("path", ["oracle", "kernel_ops"])
def test_gru_cell_matches_reference(path):
    params, xs, h0, _, _ = _gru_case(3, 5, 1, 6, 8, seed=3)
    x = xs[:, :, 0]
    jh = jax.jit(jax.vmap(jgru.gru_cell))(params, h0, x)
    tp = to_torch(params)
    cell = tgru.gru_cell if path == "oracle" else gru_ops.gru_cell
    th = cell(tp, torch.from_numpy(h0), torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=GRU_TOL,
                               rtol=GRU_TOL)


def test_gru_ops_dtype_contract():
    """Outputs in the oracle's dtype: h0's when given, else xs's."""
    params, xs, h0, _, _ = _gru_case(1, 2, 4, 4, 8)
    tp = to_torch(params)
    xs16 = torch.from_numpy(xs).to(torch.bfloat16)
    hs, last = gru_ops.gru_sequence(tp, xs16)
    assert hs.dtype == last.dtype == torch.bfloat16
    hs, _ = gru_ops.gru_sequence(tp, xs16, torch.from_numpy(h0))
    assert hs.dtype == torch.float32


@pytest.mark.parametrize("batch,agents,min_blocks,rows", [
    (7, 100, 132, 4),    # AIP training: 100 tiles of 8 leave SMs idle
    (7, 100, 66, 8),     # the backward's threshold: 100 tiles of 8 do
    (1, 100, 132, 2),    # eval_ce: one row, the smallest tile
    (16, 100, 132, 8),   # the rollout cell: 200 tiles of 8
    (64, 1, 132, 2),     # the policy shape at one agent
    (256, 1, 66, 2),
    (3, 1, 1, 4),        # a tile as small as the batch allows
    (40, 4, 1, 8)])
def test_gru_tile_rows(batch, agents, min_blocks, rows):
    """Rows a block carries: 2, 4 or 8, halved while the grid of agents
    x tiles is smaller than the card's blocks."""
    assert gru_kernel.tile_rows(batch, agents, min_blocks) == rows


def _gae_case(shape, seed=0):
    rng = np.random.RandomState(seed)
    r, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    d = (rng.rand(*shape) < 0.1).astype(np.float32)
    last = rng.randn(*shape[:-1]).astype(np.float32)
    g = rng.randn(2, *shape).astype(np.float32)
    return r, v, d, last, g


@pytest.mark.parametrize("path", ["oracle", "kernel_ops"])
@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 16), (2, 33)])
def test_gae_and_grads_match_reference(path, shape):
    r, v, d, last, g = _gae_case(shape)

    # a loss linear in (adv, ret): the gradients are the adjoint scan's
    # alone, not the forward's rounding fed back through the loss
    def jloss(r_, v_, last_):
        adv, ret = jgae.gae(r_, v_, jnp.asarray(d), last_)
        return (adv * g[0]).sum() + (ret * g[1]).sum(), (adv, ret)
    (_, (jadv, jret)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(r, v, last)

    fn = tgae.gae if path == "oracle" else gae_ops.gae
    leaves = [torch.from_numpy(x).requires_grad_() for x in (r, v, last)]
    adv, ret = fn(leaves[0], leaves[1], torch.from_numpy(d), leaves[2])
    tg = torch.from_numpy(g)
    grads = torch.autograd.grad((adv * tg[0]).sum() + (ret * tg[1]).sum(),
                                leaves)
    np.testing.assert_allclose(adv.detach().numpy(), np.asarray(jadv),
                               atol=GAE_TOL, rtol=GAE_TOL)
    np.testing.assert_allclose(ret.detach().numpy(), np.asarray(jret),
                               atol=GAE_TOL, rtol=GAE_TOL)
    for jg, tg in zip(jgrads, grads):
        assert_close_scaled(tg.numpy(), jg, GAE_TOL)


def test_gae_ops_round_trips_bf16():
    r, v, d, last, _ = _gae_case((2, 8))
    adv, ret = gae_ops.gae(torch.from_numpy(r),
                           torch.from_numpy(v).to(torch.bfloat16),
                           torch.from_numpy(d), torch.from_numpy(last))
    assert adv.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the SSD wrapper's route and grid, decided in Python before any launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,p,n,chunk,kernel", [
    (torch.bfloat16, 64, 128, 128, "ssd_chunk_sm90"),   # mamba2-780m
    (torch.bfloat16, 64, 64, 128, "ssd_chunk_sm90"),    # zamba2-1.2b
    (torch.bfloat16, 64, 128, 64, "ssd_chunk_sm90"),
    (torch.bfloat16, 64, 64, 64, "ssd_chunk_sm90"),
    (torch.float32, 64, 128, 128, "ssd_chunk"),         # no TF32
    (torch.bfloat16, 64, 128, 32, "ssd_chunk"),
    (torch.bfloat16, 16, 16, 16, "ssd_chunk"),          # reduced configs
    (torch.bfloat16, 32, 128, 128, "ssd_chunk"),
    (torch.bfloat16, 64, 32, 128, "ssd_chunk")])
def test_ssd_route(dtype, p, n, chunk, kernel):
    """bf16 at head_dim 64, chunk and state 64 or 128 goes to the
    tensor-core kernel; float32 and every other shape to the FFMA one."""
    assert ssd_kernel.route(dtype, p, n, chunk) == kernel


@pytest.mark.parametrize("bsz,nc,h,sms,g", [
    (2, 64, 48, 132, 16),   # mamba2-780m's layer: 384 blocks
    (2, 64, 64, 132, 16),   # zamba2-1.2b's: 512 blocks
    (4, 64, 48, 132, 16),   # capped at 16 heads a block
    (1, 8, 48, 132, 2),     # a short prompt: 192 blocks
    (1, 64, 13, 132, 6),    # groups of 6, 6 and 1 heads
    (1, 1, 4, 132, 1)])     # fewer (chunk, head) cells than SMs
def test_ssd_sm90_heads_per_block(bsz, nc, h, sms, g):
    """One block an SM: the most heads a block (up to 16) that still
    gives every SM a block where the cells allow it."""
    assert ssd_kernel.heads_per_block_sm90(bsz, nc, h, sms) == g
    blocks = bsz * nc * -(-h // g)
    assert blocks >= min(sms, bsz * nc * h)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_dispatch_modes_on_cpu():
    assert dispatch.use_kernel("auto", "cpu") is False
    assert dispatch.use_kernel("off", "cpu") is False
    assert dispatch.use_kernel("auto", "cuda") is True
    assert dispatch.use_kernel("on", "cuda") is True
    assert dispatch.use_kernel("off", "cuda") is False
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        dispatch.use_kernel("on", "cpu")
    with pytest.raises(ValueError):
        dispatch.use_kernel("interpret", "cpu")


def test_use_kernels_on_raises_for_cpu_tensors():
    params, xs, h0, resets, _ = _gru_case(1, 2, 3, 4, 8)
    tp = to_torch(params)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tgru.gru_sequence(tp, torch.from_numpy(xs), use_kernels="on")
    r, v, d, last, _ = _gae_case((2, 4))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tgae.gae(*map(torch.from_numpy, (r, v, d, last)), use_kernels="on")


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.resolve_device()
    assert dispatch.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_version_on_cpu():
    """A CPU tensor runs the plain version and counts no launch."""
    before = {**gru_kernel.LAUNCHES, **gae_kernel.LAUNCHES}
    params, xs, h0, resets, _ = _gru_case(2, 3, 5, 4, 8)
    gi = torch.randn(2, 5, 3, 24)
    wh, bh = torch.randn(2, 8, 24), torch.randn(2, 24)
    h0t, rt = torch.randn(2, 3, 8), torch.zeros(2, 5, 3)
    assert torch.equal(gru_kernel.gru_scan(gi, wh, bh, h0t, rt),
                       gru_ref.gru_scan(gi, wh, bh, h0t, rt))
    r, v, nv, d = (torch.randn(6, 4) for _ in range(4))
    assert torch.equal(
        gae_kernel.gae_reverse_scan(r, v, nv, d, gamma=0.9, lam=0.8),
        gae_ref.gae_reverse_scan(r, v, nv, d, gamma=0.9, lam=0.8))
    assert {**gru_kernel.LAUNCHES, **gae_kernel.LAUNCHES} == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        gru_kernel.forward(gi, wh, bh, h0t, rt)
