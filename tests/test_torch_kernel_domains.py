"""The kernels' shape domains past the port's first ranges: the same
numpy-seeded inputs through the JAX package's Pallas kernel in interpret
mode and through the port's plain version (the kernel's CPU path and its
oracle on the card), at shapes the wide routes take: the GRU at hidden
192 and 256 (``gru_fwd_cluster``/``gru_bwd_chain_cluster``), flash
attention at head_dim 16, 80 and 320 (``flash_fwd_sm90_padded`` in
bfloat16 up to 256, ``flash_fwd_padded`` otherwise), the SSD block at
chunk 256 with head_dim and state 6 (``ssd_chunk_tiled``) and in bf16
with both 64 (``ssd_chunk_sm90_long``); and the wrappers' range checks,
routes and the GRU cluster's plans, which are
decided before any launch, without a card. ``test_torch_cuda.py``
holds each new route to its plain version on the card.

Tolerances: the GRU 1e-5 (``tests/test_kernels.py``'s), absolute at
magnitudes <= 1 and relative to the largest magnitude above; flash 2e-5
in float32 and 2e-2 in bfloat16 (|err| <= tol + tol |reference|), SSD
2e-4, as ``test_torch_attention.py`` and ``test_torch_ssm.py`` hold the
first ranges."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_close_scaled
from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.gru import kernel as jgru_kernel
from repro.kernels.ssd import kernel as jssd_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.gru import kernel as gru_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel

GRU_TOL, SSD_TOL = 1e-5, 2e-4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRU_T, GRU_B = 5, 3


def _assert_close(actual, desired, tol):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# GRU, hidden above 128
# ---------------------------------------------------------------------------
def _gru_inputs(h, resets_on, seed=0):
    rng = np.random.RandomState(seed)
    gi = rng.randn(GRU_T, GRU_B, 3 * h).astype(np.float32)
    wh = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
    bh = (0.1 * rng.randn(3 * h)).astype(np.float32)
    h0 = (0.5 * rng.randn(GRU_B, h)).astype(np.float32)
    resets = ((rng.rand(GRU_T, GRU_B) < 0.3) if resets_on
              else np.zeros((GRU_T, GRU_B))).astype(np.float32)
    g = rng.randn(GRU_T, GRU_B, h).astype(np.float32)
    return gi, wh, bh, h0, resets, g


@functools.lru_cache(maxsize=None)
def _jax_gru(h):
    """hs and the gradients in (gi, wh, bh, h0) of sum(hs * g), through
    the reference's kernels in interpret mode; one compile per width
    (the resets are an argument)."""
    def loss(gi, wh, bh, h0, resets, g):
        hs = jgru_kernel.gru_scan(gi, wh, bh, h0, resets[..., None],
                                  interpret=True)
        return (hs * g).sum(), hs
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                      has_aux=True))


@pytest.mark.parametrize("resets_on", [False, True])
@pytest.mark.parametrize("h", [192, 256])
def test_gru_wide_matches_reference_kernel(h, resets_on):
    """The port's plain scan (``gru_scan`` on CPU tensors, with its agent
    axis of 1) and its autograd against the reference's forward and
    backward kernels."""
    gi, wh, bh, h0, resets, g = _gru_inputs(h, resets_on)
    (_, jhs), jgrads = _jax_gru(h)(gi, wh, bh, h0, resets, g)
    leaves = [torch.from_numpy(x)[None].requires_grad_()
              for x in (gi, wh, bh, h0)]
    before = dict(gru_kernel.LAUNCHES)
    hs = gru_kernel.gru_scan(*leaves, torch.from_numpy(resets)[None])
    grads = torch.autograd.grad(hs, leaves, torch.from_numpy(g)[None])
    assert gru_kernel.LAUNCHES == before              # no launch on the CPU
    assert_close_scaled(hs[0].detach().numpy(), jhs, GRU_TOL)
    for got, want in zip(grads, jgrads):      # dgi, dwh, dbh, dh0
        assert_close_scaled(got[0].numpy(), want, GRU_TOL)


@pytest.mark.parametrize("hdim,rows,want", [
    (64, 8, 8),       # resident routes keep the tile
    (128, 8, 8),
    (512, 8, 8),      # forward at 512: 2 x 8 x 512 floats fit
    (4096, 8, 4),     # 2 x 8 x 4096 floats do not: halved once
    (7265, 8, 2),     # 2 x 4 x 7265 floats are 32 bytes over
    (20000, 8, 2)])   # at 2 rows the wrapper's check raises
def test_gru_fit_rows(hdim, rows, want):
    """The rows of a streaming tile halve (down to 2) until its shared
    memory fits a block; csrc/gru.cu's forward needs 2 R H floats."""
    fwd = lambda hd, r: 2 * r * hd * 4
    assert gru_kernel.fit_rows(rows, hdim, fwd) == want


@pytest.mark.parametrize("hdim,want,want_bwd", [
    (1, "resident", "resident"), (128, "resident", "resident"),
    (129, "cluster", "cluster"), (256, "cluster", "cluster"),
    (512, "cluster", "cluster"), (513, "stream", "stream"),
    (7264, "stream", "stream")])
def test_gru_route_is_counted_at_launch(hdim, want, want_bwd, monkeypatch):
    """``route`` names the kernel a width runs in each direction; a
    launch's count (what a wrapper records after its kernel) adds to
    ``{name}_{route}`` on the cluster and streaming routes only."""
    assert gru_kernel.route(hdim) == want
    assert gru_kernel.route(hdim, "backward") == want_bwd
    monkeypatch.setattr(gru_kernel, "LAUNCHES", dict.fromkeys(
        gru_kernel.LAUNCHES, 0))
    monkeypatch.setattr(gru_kernel, "SHAPE_LAUNCHES",
                        {k: {} for k in gru_kernel.SHAPE_LAUNCHES})
    monkeypatch.setattr(gru_kernel, "STREAM_LAUNCHES",
                        {k: {} for k in gru_kernel.STREAM_LAUNCHES})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    for name in ("gru_forward", "gru_backward"):
        gru_kernel._count(name, (2, 3, 4, hdim), "cuda:0")
    assert gru_kernel.LAUNCHES == {
        "gru_forward": 1, "gru_backward": 1,
        "gru_forward_stream": int(want == "stream"),
        "gru_forward_cluster": int(want == "cluster"),
        "gru_backward_stream": int(want_bwd == "stream"),
        "gru_backward_cluster": int(want_bwd == "cluster")}


@pytest.mark.parametrize("hdim,plan", [
    (128, None),          # resident: no cluster
    (129, (5, 64)),       # the narrowest: 5 CTAs of 32 units
    (256, (8, 64)),       # the AIP's: 98,304 B of W_h and 131,072 of slots
    (384, (12, 16)),      # 147,456 B of W_h: 16 rows of slots fit
    (512, (16, 8)),       # 196,608 B of W_h: 8 rows
    (513, None)])         # 17 CTAs: streamed
def test_gru_backward_cluster_plan_at_the_band_edges(hdim, plan):
    """The cluster chain's plan at the AIP's batch of 100 x 128 rows: the
    forward's CTAs, and rows halved until a CTA's W_h columns (384 KP
    bytes, KP the hidden rounded up to 64) and its double-buffered slots
    (8 C R U bytes) fit a block."""
    got = gru_kernel.cluster_plan(hdim, 128, 100, 132, "backward")
    assert got == plan
    if plan is None:
        return
    ctas, rows = plan
    kp = -(-hdim // 64) * 64
    assert gru_kernel.cluster_chain_smem_bytes(hdim, ctas, rows) == \
        4 * (96 * kp + 2 * ctas * rows * 32) <= gru_kernel.MAX_SMEM_BYTES
    if rows < 64:
        assert gru_kernel.cluster_chain_smem_bytes(hdim, ctas, 2 * rows) > \
            gru_kernel.MAX_SMEM_BYTES


def test_gru_backward_plans_fit_every_cluster_width():
    """Every hidden width of the cluster band has a backward plan that
    fits a block at every batch, as the forward's does; the plans agree
    with the forward's at the widths the paths run."""
    for h in range(gru_kernel.RESIDENT_HIDDEN + 1,
                   gru_kernel.CLUSTER_HIDDEN + 1):
        for batch, agents in ((1, 1), (8, 4), (64, 16), (128, 100)):
            ctas, rows = gru_kernel.cluster_plan(h, batch, agents, 132,
                                                 "backward")
            assert gru_kernel.cluster_chain_smem_bytes(h, ctas, rows) <= \
                gru_kernel.MAX_SMEM_BYTES
    for h, batch, agents in ((256, 128, 100), (512, 64, 16), (512, 8, 4),
                             (256, 1, 4)):
        assert gru_kernel.cluster_plan(h, batch, agents, 132) == \
            gru_kernel.cluster_plan(h, batch, agents, 132, "backward")


@pytest.mark.parametrize("hdim,batch,agents,plan", [
    (129, 128, 100, (5, 64)),     # the narrowest: 5 CTAs of 32 units
    (256, 128, 100, (8, 64)),     # the AIP's: 98,304 B of W_h a CTA
    (256, 128, 4, (8, 16)),       # rows halved until 132 CTAs run
    (256, 3, 1, (8, 8)),          # a small batch: the smallest tile
    (384, 64, 16, (12, 16)),      # 147,456 B of W_h: 16 rows fit
    (512, 64, 16, (16, 8))])      # 16 CTAs of 196,608 B: 8 rows fit
def test_gru_cluster_plan_fits_a_block(hdim, batch, agents, plan):
    """The cluster forward's plan (CTAs, rows): a CTA's W_h columns and
    its double-buffered h fit a block's shared memory (12 H^2 / C bytes
    of weights at 32 units a CTA, 8 R H of h), at most 16 CTAs."""
    got = gru_kernel.cluster_plan(hdim, batch, agents, 132)
    assert got == plan
    ctas, rows = got
    assert ctas <= gru_kernel.MAX_CLUSTER
    assert 12 * 32 * hdim + 8 * rows * hdim <= \
        gru_kernel.cluster_smem_bytes(hdim, rows) <= \
        gru_kernel.MAX_SMEM_BYTES
    if rows < 64:    # twice the rows would not fit, or leave SMs idle
        assert gru_kernel.cluster_smem_bytes(hdim, 2 * rows) > \
            gru_kernel.MAX_SMEM_BYTES or min(batch, 64) <= rows or \
            agents * -(-batch // (2 * rows)) * ctas < 132


# clusters of a plan an NVIDIA H100 80GB HBM3 holds at once, by CTAs a
# cluster (gru_forward_cluster_max_active, at one CTA an SM; the backward's
# gru_backward_cluster_max_active gave the same counts)
H100_CLUSTERS = {5: 22, 8: 15, 12: 7, 16: 7}


def _h100_clusters(hdim, ctas, rows):
    return H100_CLUSTERS[ctas]


@pytest.mark.parametrize("shape,want", [
    ((100, 128, 7, 64), "resident"),
    ((100, 7, 128, 256), "cluster"),    # the AIP's training batch
    ((100, 2, 128, 256), "cluster"),    # clusters of 8 from T=2
    ((100, 1, 16, 256), "stream"),      # the rollout cell of 100 agents
    ((4, 1, 8, 256), "cluster"),        # ... of 4: 32 CTAs, one wave
    ((4, 1, 8, 512), "cluster"),        # 64 CTAs, one wave
    ((15, 1, 8, 256), "cluster"),       # 15 clusters of 8 fit at once
    ((16, 1, 8, 256), "stream"),        # 16 do not, though 128 CTAs < 132
    ((7, 1, 8, 512), "cluster"),        # 7 clusters of 16 fit at once
    ((8, 1, 8, 512), "stream"),         # 8 do not, though 128 CTAs < 132
    ((100, 1, 128, 160), "stream"),     # clusters of 5 from T=2
    ((100, 2, 128, 160), "cluster"),
    ((16, 2, 64, 384), "stream"),       # clusters of 12 from T=4
    ((16, 4, 64, 384), "cluster"),
    ((7, 1, 8, 384), "cluster"),        # 7 clusters of 12 fit at once
    ((8, 2, 8, 384), "stream"),         # 8 do not
    ((16, 4, 64, 512), "stream"),       # clusters of 16 from T=8
    ((16, 16, 64, 512), "cluster"),
    ((2, 5, 3, 640), "stream")])        # above the cluster's widest
def test_gru_forward_route_by_shape(shape, want):
    """The forward's launch route on a card of 132 SMs that holds
    H100_CLUSTERS clusters of a plan at once: the cluster kernel above
    hidden 128 where it is no slower than the streaming one, on a long
    enough sequence or a grid whose clusters all fit at once."""
    assert gru_kernel.forward_route(shape, 132, _h100_clusters) == want


def _bwd_edge(ctas):
    return next(n for c, n in sorted(
        gru_kernel.CLUSTER_MIN_STEPS_BWD.items()) if ctas <= c)


@pytest.mark.parametrize("shape,want", [
    ((100, 7, 128, 128), "resident"),   # the band's edges
    ((100, 7, 128, 129), "cluster"),
    ((16, 16, 64, 512), "cluster"),
    ((16, 16, 64, 513), "stream"),
    ((100, 7, 128, 256), "cluster"),    # the AIP's training batch
    ((4, 1, 8, 256), "cluster"),        # 4 clusters: one wave at T=1
    ((4, 1, 8, 512), "cluster"),
    ((15, 1, 8, 256), "cluster"),       # 15 clusters of 8 fit at once
    ((16, 1, 8, 256), None),            # 16 do not: the edge in T decides
    ((8, 1, 8, 512), None),
    ((100, 1, 128, 160), None),
    ((16, 1, 64, 384), None)])
def test_gru_backward_route_by_shape(shape, want):
    """The backward's chain on a card of 132 SMs that holds H100_CLUSTERS
    clusters of a plan at once: the cluster chain from hidden 129 to 512
    where all its clusters fit at once or the sequence is at least
    CLUSTER_MIN_STEPS_BWD long (by the plan's CTAs), streaming one step
    shorter; resident and streaming outside the band."""
    a, t, b, h = shape
    if want is not None:
        assert gru_kernel.backward_route(shape, 132, _h100_clusters) == want
        return
    ctas, _ = gru_kernel.cluster_plan(h, b, a, 132, "backward")
    edge = _bwd_edge(ctas)
    for steps, kind in ((edge - 1, "stream"), (edge, "cluster")):
        if steps >= 1:
            assert gru_kernel.backward_route(
                (a, steps, b, h), 132, _h100_clusters) == kind


def test_gru_cluster_plan_ends_at_its_widest_hidden():
    """Every width from 129 to CLUSTER_HIDDEN has a plan, the next has
    none (17 CTAs), and ``route`` names ``"stream"`` there."""
    widths = range(gru_kernel.RESIDENT_HIDDEN + 1,
                   gru_kernel.CLUSTER_HIDDEN + 1)
    assert all(gru_kernel.cluster_plan(h, 8) is not None for h in widths)
    assert gru_kernel.cluster_plan(gru_kernel.CLUSTER_HIDDEN + 1, 8) is None
    assert gru_kernel.cluster_plan(gru_kernel.RESIDENT_HIDDEN, 8) is None
    assert gru_kernel.route(gru_kernel.CLUSTER_HIDDEN + 1) == "stream"


def test_gru_range_checks_without_a_card():
    """No upper bound on the hidden width in the wrapper: a width is held
    only to shared memory (the chain's 4 R H floats), with a message that
    names it."""
    assert not hasattr(gru_kernel, "MAX_HIDDEN")
    chain = lambda hd, r: 4 * r * hd * 4
    assert chain(7264, gru_kernel.fit_rows(8, 7264, chain)) <= \
        gru_kernel.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory at hidden 7265"):
        gru_kernel._check_smem(chain(7265, 2), "backward", 7265)


# ---------------------------------------------------------------------------
# flash attention, head_dim outside 64/128/256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80, 320])
def test_flash_head_dims_match_reference_kernel(d, dtype):
    """Causal, window 24, softcap 20 (q, k, v scaled by 3, so the cap
    bites), GQA 2:1, T=48: the port's plain version against the reference
    kernel."""
    rng = np.random.RandomState(d)
    t, h, hkv = 48, 4, 2
    arrs = [3.0 * rng.randn(n, t, d).astype(np.float32)
            for n in (h, hkv, hkv)]
    kw = dict(causal=True, sliding_window=24, softcap=20.0)
    want = jfa_kernel.flash_attention_bhsd(
        *(jnp.asarray(a).astype(JDT[dtype]) for a in arrs), interpret=True,
        **kw)
    got = fa_kernel.flash_attention_bhsd(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in arrs), **kw)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (h, t, d)
    _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                  FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "flash_fwd_sm90"),
    (torch.bfloat16, 128, "flash_fwd_sm90"),
    (torch.bfloat16, 256, "flash_fwd_sm90"),
    (torch.bfloat16, 16, "flash_fwd_sm90_padded"),   # the reduced gemma2-9b
    (torch.bfloat16, 96, "flash_fwd_sm90_padded"),
    (torch.bfloat16, 512, "flash_fwd_padded"),
    (torch.float32, 64, "flash_fwd"),
    (torch.float32, 256, "flash_fwd"),
    (torch.float32, 320, "flash_fwd_padded"),
    (torch.bfloat16, 1, "flash_fwd_sm90_padded"),
    (torch.bfloat16, 20, "flash_fwd_sm90_padded"),   # rows padded to 24
    (torch.bfloat16, 200, "flash_fwd_sm90_padded"),  # DP 256
    (torch.bfloat16, 257, "flash_fwd_padded"),
    (torch.float32, 16, "flash_fwd_padded"),
    (torch.float32, 96, "flash_fwd_padded")])
def test_flash_route(dtype, d, kernel):
    """At 64, 128 or 256 bf16 stays on the tensor-core kernel and float32
    on the FFMA kernel ``flash_fwd``; bf16 at the other head_dims up to
    256 goes to ``flash_fwd_sm90_padded``, and the rest (float32, bf16
    above 256) to ``flash_fwd_padded``."""
    assert fa_kernel.route(dtype, d) == kernel
    assert kernel in fa_kernel.ROUTES


def test_flash_range_checks_without_a_card():
    """1..512 is taken; the padded cases fit a block, the smallest tiles
    at 512 included; above 512 the message names shared memory."""
    for d in (1, 16, 63, 80, 192, 257, 320, 384, 511, 512):
        fa_kernel.check_head_dim(d)
        assert fa_kernel.ffma_smem_bytes(d) <= fa_kernel.MAX_SMEM_BYTES
    assert fa_kernel.ffma_smem_bytes(256) == 4 * (2 * 64 * 260 + 64 * 256
                                                  + 64 * 68)
    with pytest.raises(ValueError, match="shared memory"):
        fa_kernel.check_head_dim(513)
    with pytest.raises(ValueError, match=">= 1"):
        fa_kernel.check_head_dim(0)


# ---------------------------------------------------------------------------
# SSD, chunk 256 and odd head_dim and state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk256_p6_n6_matches_reference_kernel(dtype):
    """The intra-chunk block at chunk 256, head_dim and state 6, two
    chunks: the port's plain version against the reference kernel (bf16
    y within 1e-2 scaled, as test_torch_ssm.py holds a bf16 block; the
    float32 states and decay within 2e-4)."""
    rng = np.random.RandomState(7)
    b, t, h, p, n, chunk = 1, 512, 2, 6, 6, 256
    x = rng.randn(b, t, h, p).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(b, t, h))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = rng.randn(b, t, n).astype(np.float32)
    c = rng.randn(b, t, n).astype(np.float32)
    xw, la = x * dt[..., None], dt * a
    want = jssd_kernel.ssd_intra_chunk(
        jnp.asarray(xw).astype(JDT[dtype]), jnp.asarray(la),
        jnp.asarray(bm).astype(JDT[dtype]), jnp.asarray(c).astype(JDT[dtype]),
        chunk=chunk, interpret=True)
    got = ssd_kernel.ssd_intra_chunk(
        torch.from_numpy(xw).to(TDT[dtype]), torch.from_numpy(la),
        torch.from_numpy(bm).to(TDT[dtype]), torch.from_numpy(c).to(
            TDT[dtype]), chunk=chunk)
    y_tol = SSD_TOL if dtype == "float32" else 1e-2
    assert_close_scaled(got[0].float().numpy(),
                        np.asarray(want[0].astype(jnp.float32)), y_tol)
    for g, w in zip(got[1:], want[1:]):
        assert_close_scaled(g.numpy(), np.asarray(w), SSD_TOL)


@pytest.mark.parametrize("dtype,p,n,chunk,kernel", [
    (torch.bfloat16, 64, 128, 256, "ssd_chunk_sm90_long"),  # mamba2's layer
    (torch.bfloat16, 64, 64, 256, "ssd_chunk_sm90_long"),
    (torch.bfloat16, 64, 128, 128, "ssd_chunk_sm90"),   # the old route
    (torch.bfloat16, 64, 64, 64, "ssd_chunk_sm90"),
    (torch.float32, 64, 128, 256, "ssd_chunk_tiled"),   # float32 stays
    (torch.bfloat16, 32, 128, 256, "ssd_chunk_tiled"),  # P != 64
    (torch.bfloat16, 64, 96, 256, "ssd_chunk_tiled"),   # N not 64 or 128
    (torch.bfloat16, 64, 128, 512, "ssd_chunk_tiled"),  # chunk 512
    (torch.bfloat16, 6, 6, 256, "ssd_chunk_tiled"),
    (torch.float32, 6, 6, 256, "ssd_chunk_tiled"),
    (torch.float32, 6, 6, 32, "ssd_chunk_tiled"),     # P, N not of 4
    (torch.float32, 64, 64, 24, "ssd_chunk_tiled"),   # L not of 16
    (torch.float32, 256, 256, 64, "ssd_chunk_tiled"),
    (torch.float32, 128, 128, 128, "ssd_chunk_tiled"),  # 265 KB of tiles
    (torch.float32, 64, 128, 128, "ssd_chunk"),       # 231,936 bytes
    (torch.bfloat16, 64, 128, 128, "ssd_chunk_sm90")])
def test_ssd_route_past_the_first_ranges(dtype, p, n, chunk, kernel):
    """bf16 at P 64, N 64 or 128 goes to the tensor cores, at chunk 64 and
    128 to ``ssd_chunk_sm90``, at 256 to ``ssd_chunk_sm90_long``;
    ``ssd_chunk`` keeps the float32 shapes whose whole-chunk tiles fit;
    every other chunk, P and N goes to the tiled pair."""
    assert ssd_kernel.route(dtype, p, n, chunk) == kernel
    assert kernel in ssd_kernel.LAUNCHES


@pytest.mark.parametrize("bsz,nc,h,want", [
    (2, 32, 48, 8),     # mamba2-780m at chunk 256: 3,072 head-chunks
    (1, 2, 2, 1),       # fewer head-chunks than SMs: one head a block
    (1, 8, 40, 2)])
def test_ssd_long_heads_per_block(bsz, nc, h, want):
    """``ssd_chunk_sm90_long`` takes up to 8 heads a block (the most whose
    cs and w fit beside B, C and the X ring), fewer where the grid would
    leave SMs without a block."""
    assert ssd_kernel.heads_per_block_long(bsz, nc, h, 132) == want


def test_ssd_chunk256_p64_n64_bf16_matches_reference_kernel():
    """The bf16 block the long tensor-core route takes, at its smallest
    (chunk 256, head_dim 64, state 64, one chunk of two heads): the port's
    plain version (the route's CPU path and its oracle on the card)
    against the reference kernel in interpret mode; bf16 y within 1e-2
    scaled, the float32 states and decay within 2e-4."""
    rng = np.random.RandomState(29)
    b, t, h, p, n, chunk = 1, 256, 2, 64, 64, 256
    x = rng.randn(b, t, h, p).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(b, t, h))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = rng.randn(b, t, n).astype(np.float32)
    c = rng.randn(b, t, n).astype(np.float32)
    xw, la = x * dt[..., None], dt * a
    assert ssd_kernel.route(torch.bfloat16, p, n, chunk) == \
        "ssd_chunk_sm90_long"
    want = jssd_kernel.ssd_intra_chunk(
        jnp.asarray(xw).astype(jnp.bfloat16), jnp.asarray(la),
        jnp.asarray(bm).astype(jnp.bfloat16),
        jnp.asarray(c).astype(jnp.bfloat16), chunk=chunk, interpret=True)
    before = dict(ssd_kernel.LAUNCHES)
    got = ssd_kernel.ssd_intra_chunk(
        torch.from_numpy(xw).bfloat16(), torch.from_numpy(la),
        torch.from_numpy(bm).bfloat16(), torch.from_numpy(c).bfloat16(),
        chunk=chunk)
    assert ssd_kernel.LAUNCHES == before             # no launch on the CPU
    assert got[0].dtype == torch.bfloat16
    assert_close_scaled(got[0].float().numpy(),
                        np.asarray(want[0].astype(jnp.float32)), 1e-2)
    for g, w in zip(got[1:], want[1:]):
        assert_close_scaled(g.numpy(), np.asarray(w), SSD_TOL)


def test_ssd_range_checks_without_a_card():
    for t, p, n, chunk in ((512, 6, 6, 256), (96, 1, 1, 96), (7, 3, 5, 7)):
        ssd_kernel.check_shape(t, p, n, chunk)
    with pytest.raises(ValueError, match="divide T=512"):
        ssd_kernel.check_shape(512, 6, 6, 96)
    with pytest.raises(ValueError, match="must be >= 1"):
        ssd_kernel.check_shape(512, 0, 6, 256)
    assert ssd_kernel.ffma_smem_bytes(128, 64, 128) == 231936
