"""The port's CUDA kernels against their plain torch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without an
NVIDIA GPU. The file imports neither JAX nor the JAX package, so it runs
on a GPU machine without them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: GRU 1e-5 times max(1, largest magnitude), also for
the kernel's dW_h and db_h against float64 sums; GAE forward bit
for bit, its gradients 1e-6 likewise. Flash attention |err| <= tol +
tol·|plain| with tol 2e-5 in float32 (the FFMA kernel) and 2e-2 in
bfloat16 (the tensor-core kernel), the reference's own
(``tests/test_kernels.py``; in bf16 the plain version rounds the
probabilities to bf16 before p·v and the kernel rounds them to bf16 for
its bf16 product). The bf16 kernel is also held, with q scaled by 8 so the
scores reach the softcap, to the plain version run in float32 on the same
bf16 inputs within 1e-3 + 8e-3·|plain| (``chip_smoke.py``'s limit: p and
the output rounded to bf16, 2^-9 and 2^-8 relative). SSD
2e-4 likewise in float32 (``tests/test_kernels.py``); in bfloat16 the
outputs stored in bf16 within 1e-2 times max(1, largest magnitude) (two
roundings of 2^-8 each), the float32 states within 2e-4 likewise, on
both kernels (``ssd_chunk_sm90`` for bf16 at the shapes it takes,
``ssd_chunk`` otherwise).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gae import kernel as gae_kernel
from repro_torch.kernels.gae import ref as gae_ref
from repro_torch.kernels.gru import kernel as gru_kernel
from repro_torch.kernels.gru import ref as gru_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.nn import ssm as ssm_mod

GRU_TOL, GAE_TOL = 1e-5, 1e-6
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_BF16_F32_TOL = (1e-3, 8e-3)
SSD_TOL, SSD_BF16_TOL = 2e-4, 1e-2


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_close_scaled(actual, desired, tol):
    actual, desired = actual.detach().double(), desired.detach().double()
    err = float((actual - desired).abs().max())
    scale = max(1.0, float(desired.abs().max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def _gru_inputs(device, a, t, b, h, seed, reset_p=0.2):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
    ins = [rnd(a, t, b, 3 * h), rnd(a, h, 3 * h) / h ** 0.5,
           0.1 * rnd(a, 3 * h), rnd(a, b, h)]
    resets = (torch.rand(a, t, b, generator=gen, device=device)
              < reset_p).float()
    return ins, resets, rnd(a, t, b, h)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [
    (3, 17, 5, 16), (2, 9, 21, 64), (4, 1, 16, 64), (100, 128, 7, 64),
    (100, 1, 16, 64),     # the rollout cell (T=1, two batch tiles)
    (2, 33, 20, 128),     # H=128 (W_h in shared memory), three batch tiles
    (1, 16, 64, 128),     # BENCH_kernels.json's policy shape
    (2, 13, 9, 96),       # a hidden width that is not a power of two
    (3, 7, 2, 128),       # two rows a tile: lanes share rows
    (2, 5, 1, 40),        # one row a tile
    (100, 16, 4, 128),    # the recurrent policy's ppo_loss
    (100, 1, 16, 128)])   # the recurrent policy's rollout cell
def test_gru_kernels_match_plain(cuda_device, a, t, b, h):
    """Forward and backward, with resets, over one and several batch
    tiles (b=21 spans three tiles of 8) and at the main path's shapes."""
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=0)
    k_leaves = [x.clone().requires_grad_() for x in ins]
    p_leaves = [x.clone().requires_grad_() for x in ins]
    hs_k = gru_kernel.GRUScan.apply(*k_leaves, resets)
    hs_p = gru_ref.gru_scan(*p_leaves, resets)
    assert_close_scaled(hs_k, hs_p, GRU_TOL)
    for gk, gp in zip(torch.autograd.grad(hs_k, k_leaves, g),
                      torch.autograd.grad(hs_p, p_leaves, g)):
        assert_close_scaled(gk, gp, GRU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(4, 12, 40, 64), (2, 20, 24, 128),
                                     (100, 16, 4, 128), (100, 1, 16, 128)])
def test_gru_backward_is_deterministic(cuda_device, a, t, b, h):
    """dW_h and db_h sum all T.B rows in a fixed order, with no atomics:
    two runs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    ins = (rnd(a, t, b, 3 * h), rnd(a, h, 3 * h) / 8, rnd(a, 3 * h),
           rnd(a, b, h), torch.zeros(a, t, b, device=cuda_device))
    hs = gru_kernel.forward(*ins)
    g = rnd(a, t, b, h)
    first = gru_kernel.backward(*ins, hs, g)
    second = gru_kernel.backward(*ins, hs, g)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(2, 128, 64, 64), (1, 64, 64, 128)])
def test_gru_weight_grads_match_float64_sums(cuda_device, a, t, b, h):
    """dW_h and db_h, summed by the kernel over all T.B rows in float32,
    against the plain version run in float64 on the same inputs (its
    dW_h a float64 sum over the same rows), at GRU_TOL times max(1,
    largest magnitude)."""
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=4,
                                 reset_p=0.05)
    hs = gru_kernel.forward(*ins, resets)
    _, dwh, dbh, _ = gru_kernel.backward(*ins, resets, hs, g)
    leaves = [x.double().requires_grad_() for x in ins]
    hs64 = gru_ref.gru_scan(*leaves, resets.double())
    _, dwh64, dbh64, _ = torch.autograd.grad(hs64, leaves, g.double())
    assert_close_scaled(dwh, dwh64, GRU_TOL)
    assert_close_scaled(dbh, dbh64, GRU_TOL)


@pytest.mark.cuda
def test_recurrent_policy_sequence_kernel_matches_plain(cuda_device):
    """``policy_sequence`` of the GRU policy (with resets and a non-zero
    h0) through the scan kernels against ``use_kernels="off"`` on the
    same params: outputs and parameter gradients within GRU_TOL times
    max(1, largest magnitude)."""
    from repro_torch import random as R
    from repro_torch.marl import policy
    a, b, t, obs_dim = 3, 6, 11, 9
    cfgs = {mode: policy.PolicyConfig(obs_dim, 4, kind="gru", hidden=(32,),
                                      gru_hidden=24, use_kernels=mode)
            for mode in ("on", "off")}
    params = policy.policy_init(R.split(R.key(0, cuda_device), a),
                                cfgs["on"])
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    obs = torch.randn(a, b, t, obs_dim, generator=gen, device=cuda_device)
    h0 = 0.5 * torch.randn(a, b, 24, generator=gen, device=cuda_device)
    resets = (torch.rand(a, b, t, generator=gen, device=cuda_device)
              < 0.2).float()
    outs = {}
    launched = dict(gru_kernel.LAUNCHES)
    for mode, cfg in cfgs.items():
        leaves = [p.clone().requires_grad_() for p in
                  (params["gru"]["wi"], params["gru"]["wh"],
                   params["gru"]["bh"])]
        p = {**params, "gru": {**params["gru"], "wi": leaves[0],
                               "wh": leaves[1], "bh": leaves[2]}}
        logits, values = policy.policy_sequence(p, obs, h0, resets, cfg)
        grads = torch.autograd.grad(logits.square().sum() + values.sum(),
                                    leaves)
        outs[mode] = (logits, values) + grads
    # "on" went through both kernels, once each
    for name in ("gru_forward", "gru_backward"):
        assert gru_kernel.LAUNCHES[name] == launched[name] + 1, name
    for k, p in zip(outs["on"], outs["off"]):
        assert_close_scaled(k, p, GRU_TOL)


@pytest.mark.cuda
def test_traffic_gs_trajectory_on_card_equals_cpu(cuda_device):
    """A traffic GS pool (side 4, 8 streams) under seeded actions for 40
    steps with auto-reset: every state field, observation, reward and
    influence bit equal on the card and on the CPU."""
    from repro_torch import random as R
    from repro_torch.core import env_pool
    from repro_torch.envs import registry
    mod, cfg = registry.make("traffic", side=4, horizon=16)
    runs = {}
    for dev in ("cpu", cuda_device):
        pool = env_pool.GSPool(mod, cfg, 8)
        skeys = env_pool.stream_keys(R.key(5, dev), 8)
        env = pool.init(skeys)
        out = []
        for t in range(40):
            k_act, k_env, k_reset = env_pool.step_keys(skeys, t, 3)
            action = R.randint(k_act, (cfg.n_agents,), 0, 2)
            env, obs, rew, u, done = pool.step_reset(env, action, k_env,
                                                     k_reset)
            out += [env["lanes"], env["phase"], env["t"], obs, rew, u, done]
        runs[str(dev)] = [x.cpu() for x in out]
    for x, y in zip(runs["cpu"], runs[str(cuda_device)]):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("t,b", [(16, 1600), (256, 7), (16, 1601),
                                 (37, 96)])
def test_gae_kernels_match_plain_bitwise(cuda_device, t, b):
    """The forward bit for bit and the gradients within 1e-6 at the DIALS
    shape, a long T (several load tiles), an odd B and a T that is no
    multiple of the tile."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r, v, nv, g = (torch.randn(t, b, generator=gen, device=cuda_device)
                   for _ in range(4))
    d = (torch.rand(t, b, generator=gen, device=cuda_device)
         < 0.1).float()
    k_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    p_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    adv_k = gae_kernel.GAEScan.apply(*k_leaves, d, 0.99, 0.95)
    adv_p = gae_ref.gae_reverse_scan(*p_leaves, d, gamma=0.99, lam=0.95)
    assert torch.equal(adv_k, adv_p)
    for gk, gp in zip(torch.autograd.grad(adv_k, k_leaves, g),
                      torch.autograd.grad(adv_p, p_leaves, g)):
        assert_close_scaled(gk, gp, GAE_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(cuda_device):
    gi = torch.zeros(1, 2, 3, 24, device=cuda_device)
    wh, bh = torch.zeros(1, 8, 24, device=cuda_device), \
        torch.zeros(1, 24, device=cuda_device)
    h0, resets = torch.zeros(1, 3, 8, device=cuda_device), \
        torch.zeros(1, 2, 3, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.forward(gi.double(), wh, bh, h0, resets)
    with pytest.raises(ValueError, match="contiguous"):
        gru_kernel.forward(gi.transpose(1, 2).contiguous().transpose(1, 2),
                           wh, bh, h0, resets)
    with pytest.raises(ValueError, match="shape"):
        gru_kernel.forward(gi, wh, bh, h0[:, :2], resets)
    wide = torch.zeros(1, 2, 3, 3 * 136, device=cuda_device)
    with pytest.raises(ValueError, match="hidden 136"):
        gru_kernel.forward(wide, torch.zeros(1, 136, 408, device=cuda_device),
                           torch.zeros(1, 408, device=cuda_device),
                           torch.zeros(1, 3, 136, device=cuda_device), resets)
    r = torch.zeros(4, 5, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        gae_kernel.forward(r, r, r, r[:3], 0.9, 0.9)


def assert_allclose(actual, desired, tol):
    """|actual - desired| <= tol + tol·|desired| elementwise."""
    actual, desired = actual.detach().double(), desired.detach().double()
    bad = (actual - desired).abs() > tol + tol * desired.abs()
    err = float((actual - desired).abs().max())
    assert not bool(bad.any()), f"max abs err {err:.3e} (tol {tol})"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,window,softcap,causal", [
    (1, 200, 4, 2, 64, None, None, True),    # T not a tile multiple, GQA
    (2, 256, 8, 2, 64, 64, 50.0, True),      # window + softcap
    (1, 384, 4, 2, 256, 128, 50.0, True),    # gemma2's head_dim
    (1, 130, 2, 1, 256, None, 50.0, True),   # MQA, ragged T
    (2, 128, 4, 4, 128, None, None, False),  # non-causal
    (1, 130, 8, 2, 128, 100, 50.0, True),    # GQA 4:1, window 100, ragged T
    (1, 4100, 4, 2, 256, 100, 50.0, True),   # long ragged T, window 100
    (2, 300, 4, 4, 256, 17, None, True),     # window under a key tile
    (1, 200, 4, 1, 256, None, 30.0, False),  # MQA, non-causal, D=256
])
def test_flash_kernel_matches_plain(cuda_device, dtype, b, t, h, hkv, d,
                                    window, softcap, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device,
                                 dtype=torch.float32).to(dtype)
    q, k, v = rnd(b, t, h, d) * 2, rnd(b, t, hkv, d) * 2, rnd(b, t, hkv, d)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    before = fa_kernel.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert_allclose(out, fa_ref.attention(q, k, v, **kw), FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,bhkv,t,d,window,softcap,causal", [
    (4, 2, 200, 64, None, None, True),     # GQA 2:1, T not a tile multiple
    (8, 2, 130, 128, 100, 50.0, True),     # GQA 4:1, window 100
    (4, 1, 4100, 256, 100, 50.0, True),    # MQA, long ragged T
    (4, 2, 300, 256, 17, 50.0, True),      # window under a key tile
    (4, 4, 256, 64, 64, 50.0, True),       # MHA, window a tile multiple
    (4, 2, 200, 128, None, 30.0, False),   # non-causal, ragged Tk
])
def test_flash_bf16_kernel_matches_plain_in_float32(
        cuda_device, bh, bhkv, t, d, window, softcap, causal):
    """The tensor-core kernel on bf16 inputs, q scaled by 8 so a few keys
    lead each softmax and the scores reach the softcap, against the plain
    version in float32 on the same inputs: a mask, tile, swizzle or
    fragment fault moves outputs by order |v| = 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    q = (rnd(bh, t, d) * 8).bfloat16()
    k, v = rnd(bhkv, t, d).bfloat16(), rnd(bhkv, t, d).bfloat16()
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    out = fa_kernel.forward(q, k, v, **kw)
    want = fa_ref.attention_bhsd(q.float(), k.float(), v.float(), **kw)
    atol, rtol = FLASH_BF16_F32_TOL
    diff = (out.double() - want.double()).abs()
    bad = diff > atol + rtol * want.double().abs()
    assert not bool(bad.any()), \
        f"max abs err {float(diff.max()):.3e} at rows " \
        f"{bad.any(-1).nonzero()[:4].tolist()}"


@pytest.mark.cuda
def test_flash_routes_by_dtype(cuda_device):
    """bf16 goes to the tensor-core kernel and float32 to the FFMA kernel,
    which still holds the reference's 2e-5; each launch counts once in
    ``flash_attention`` and once under its kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(4, 192, 128, generator=gen, device=cuda_device)
               for _ in range(3))
    kw = dict(causal=True, sliding_window=70, softcap=50.0)
    counts = dict(fa_kernel.LAUNCHES)
    out = fa_kernel.forward(q, k, v, **kw)
    assert_allclose(out, fa_ref.attention_bhsd(q, k, v, **kw),
                    FLASH_TOL[torch.float32])
    assert fa_kernel.LAUNCHES["flash_fwd"] == counts["flash_fwd"] + 1
    assert fa_kernel.LAUNCHES["flash_fwd_sm90"] == counts["flash_fwd_sm90"]
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = fa_kernel.forward(qb, kb, vb, **kw)
    assert out.dtype == torch.bfloat16
    assert fa_kernel.LAUNCHES["flash_fwd_sm90"] == \
        counts["flash_fwd_sm90"] + 1
    assert fa_kernel.LAUNCHES["flash_fwd"] == counts["flash_fwd"] + 1
    assert fa_kernel.LAUNCHES["flash_attention"] == \
        counts["flash_attention"] + 2
    # a view that is not 16-byte aligned cannot feed the tensor maps
    flat = torch.zeros(4 * 192 * 128 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    odd = flat[1:].view(4, 192, 128)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.forward(odd, kb, vb, **kw)


def _ragged_heads(device, b, t, chunk):
    """A head count that the tensor-core kernel's heads_per_block does not
    divide on this card: its last block takes fewer heads."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for h in (13, 11, 17, 19, 23, 7, 5):
        g = ssd_kernel.heads_per_block_sm90(b, t // chunk, h, sms)
        if h % g:
            return h
    raise AssertionError(f"no ragged head count at {sms} SMs")


def _ssd_inputs(gen, device, b, t, h, p, n, dtype):
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = rnd(b, t, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, t, h)) * 0.1
    a = -torch.exp(rnd(h) * 0.3)
    return x, dt, a, rnd(b, t, n).to(dtype), rnd(b, t, n).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 128, 2, 16, 16, 32), (2, 256, 4, 32, 32, 64),
    (1, 64, 1, 8, 64, 64), (2, 512, 6, 64, 128, 128),
    (1, 1024, 48, 64, 128, 128),      # mamba2-780m's widths
    (1, 512, 64, 64, 64, 128),        # zamba2-1.2b's widths
    (2, 512, 6, 64, 128, 64), (1, 256, 4, 64, 64, 64),   # chunk 64
    (1, 8192, None, 64, 128, 128)])   # H no multiple of a block's heads
def test_ssd_kernel_matches_plain(cuda_device, dtype, b, t, h, p, n, chunk):
    """The kernel's three outputs against the plain intra-chunk block,
    and ``ops.ssd`` (with an initial state, over several chunks) against
    ``ssd_chunked``; bf16 at head_dim 64 runs the tensor-core kernel."""
    h = h or _ragged_heads(cuda_device, b, t, chunk)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x, dt, a, bm, c = _ssd_inputs(gen, cuda_device, b, t, h, p, n, dtype)
    xw = (x * dt[..., None].to(dtype)).contiguous()
    la = (dt * a).contiguous()
    key = ssd_kernel.route(dtype, p, n, chunk)
    assert key == ("ssd_chunk_sm90" if dtype == torch.bfloat16 and p == 64
                   else "ssd_chunk")
    before = dict(ssd_kernel.LAUNCHES)
    got = ssd_kernel.forward(xw, la, bm, c, chunk=chunk)
    want = ssd_ref.intra_chunk(xw, la, bm, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd_intra_chunk"] == \
        before["ssd_intra_chunk"] + 1
    assert ssd_kernel.LAUNCHES[key] == before[key] + 1
    assert got[0].dtype == dtype
    if dtype == torch.float32:
        for g, w in zip(got, want):
            assert_allclose(g, w, SSD_TOL)
    else:
        assert_close_scaled(got[0], want[0], SSD_BF16_TOL)
        for g, w in zip(got[1:], want[1:]):
            assert_close_scaled(g, w, SSD_TOL)

    s0 = torch.randn(b, h, p, n, generator=gen, device=cuda_device)
    y_k, s_k = ssd_ops.ssd(x, dt, a, bm, c, chunk=chunk, initial_state=s0)
    y_p, s_p = ssm_mod.ssd_chunked(x, dt, a, bm, c, chunk=chunk,
                                   initial_state=s0)
    if dtype == torch.float32:
        assert_allclose(y_k, y_p, SSD_TOL)
        assert_allclose(s_k, s_p, SSD_TOL)
    else:
        assert_close_scaled(y_k, y_p, SSD_BF16_TOL)
        assert_close_scaled(s_k, s_p, SSD_TOL)


@pytest.mark.cuda
def test_ssd_routes_by_dtype_and_shape(cuda_device):
    """bf16 at mamba2's widths goes to ``ssd_chunk_sm90``; float32, and
    bf16 at chunk 32, go to ``ssd_chunk``; each launch also counts once in
    ``ssd_intra_chunk``."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    cases = [(torch.bfloat16, 128, "ssd_chunk_sm90"),
             (torch.float32, 128, "ssd_chunk"),
             (torch.bfloat16, 32, "ssd_chunk")]
    for dtype, chunk, key in cases:
        x, dt, a, bm, c = _ssd_inputs(gen, cuda_device, 1, 256, 4, 64, 128,
                                      dtype)
        xw = (x * dt[..., None].to(dtype)).contiguous()
        la = (dt * a).contiguous()
        counts = dict(ssd_kernel.LAUNCHES)
        got = ssd_kernel.forward(xw, la, bm, c, chunk=chunk)
        assert ssd_kernel.route(dtype, 64, 128, chunk) == key
        assert {k: ssd_kernel.LAUNCHES[k] - counts[k] for k in counts} == {
            "ssd_intra_chunk": 1, "ssd_chunk_sm90": int(key != "ssd_chunk"),
            "ssd_chunk": int(key == "ssd_chunk")}
        want = ssd_ref.intra_chunk(xw, la, bm, c, chunk=chunk)
        tol = SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL
        assert_close_scaled(got[0], want[0], tol)
        for g, w in zip(got[1:], want[1:]):
            assert_close_scaled(g, w, SSD_TOL)
    flat = torch.zeros(256 * 4 * 64 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    odd = flat[1:].view(1, 256, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        ssd_kernel.forward(odd, la, bm.bfloat16(), c.bfloat16(), chunk=128)


@pytest.mark.cuda
def test_lm_kernel_wrappers_refuse_bad_inputs(cuda_device):
    q = torch.zeros(4, 64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.forward(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="float32"):
        fa_kernel.forward(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                          q, q)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.forward(q[..., :32].contiguous(), q[..., :32].contiguous(),
                          q[..., :32].contiguous())
    xw = torch.zeros(1, 64, 2, 8, device=cuda_device)
    la = torch.zeros(1, 64, 2, device=cuda_device)
    bm = torch.zeros(1, 64, 16, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_kernel.forward(xw.double(), la, bm.double(), bm.double(),
                           chunk=32)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_kernel.forward(xw.bfloat16(), la, bm, bm, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.forward(xw, la, bm.transpose(1, 2).contiguous()
                           .transpose(1, 2), bm, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.forward(xw, la, bm, bm, chunk=24)
