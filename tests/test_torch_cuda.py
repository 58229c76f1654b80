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
``ssd_chunk`` otherwise). The sharded round: one shard with the kernels
against the plain versions (AIP params 1e-5 scaled, policy params 1e-4,
CE 1e-5) and bit for bit the loop driver; two ranks sharing the card
against the loop driver (AIP 1e-6, CE and IALS reward 1e-5, GS return
5e-2; policy 1e-2, the reference's, and nearer the loop's policy than
half the loop's own move from init), each rank's collect bit for bit,
and every collective wrapper on CUDA tensors exactly. The fault path:
a two-rank distributed checkpoint saved and restored on the card bit for
bit, ``ReshardCollectives`` on the card's re-shard transfers, and the
peer-failure markers on the errors a broken group raises while it
reduces CUDA tensors. LM training: reduced tinyllama in float32, every
gradient leaf and two train steps on the card against the CPU within
1e-4 of each leaf's largest magnitude, no kernel launched. The bench
tools: ``benchmarks/torch_kernels.py --fast`` in process, its record
through ``benchmarks/torch_check_bench.py`` against itself (no finding),
and a short telemetry run's log through ``tools/telemetry_report_torch.py
--check``; ``benchmarks/torch_scaling.py --fast`` at traffic-2x2 in
process (the loop row, two gloo ranks sharing the card, a stream row),
its rows exactly the three labels and the GAE forward launched;
``benchmarks/torch_run.py --only fig4_f_sweep --fast --shards 2`` on two
spawned ranks, its rows under the reference's labels and keys. The wide
routes (GRU above hidden 128, flash at head_dims outside 64/128/256 in
both dtypes, SSD at any chunk, P and N) at the tolerances above, against
the plain versions; the bf16 FFMA flash kernel against the plain version
in float32 on the same inputs (FLASH_BF16_F32_TOL).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

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


def _max_active(direction="forward"):
    """The card's ``max_active`` for ``gru_kernel.forward_route`` (or
    ``backward_route``)."""
    from repro_torch.kernels import build
    ext = build.extension()
    return (ext.gru_forward_cluster_max_active if direction == "forward"
            else ext.gru_backward_cluster_max_active)


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
    (100, 1, 16, 128),    # the recurrent policy's rollout cell
    (2, 5, 3, 192),       # H > 128: W_h streamed from L2
    (2, 6, 3, 256),
    (2, 9, 21, 512),      # three tiles at H=512
    (3, 4, 2, 300),       # a streaming width no warp multiple
    (100, 7, 128, 256),   # full width: 100 agents, 16 tiles each
    (100, 1, 16, 256),    # the rollout cell (T=1) of 100 agents: streamed
    (4, 1, 9, 512),       # T=1, 8 clusters of 16 CTAs: more than fit
    (3, 1, 9, 512),       # T=1 in 16-CTA clusters, 6 fit at once
    (4, 1, 8, 256),       # the rollout cell on the cluster route
    (16, 16, 64, 512),    # the policy-like wide shape
    (2, 5, 3, 640),       # above the cluster's widest: streamed
    (3, 6, 70, 129)])     # the narrowest cluster: 5 CTAs, 2 tiles of 64
def test_gru_kernels_match_plain(cuda_device, a, t, b, h):
    """Forward and backward, with resets, over one and several batch
    tiles (b=21 spans three tiles of 8) and at the main path's shapes;
    each launch is counted under the route ``route`` names for its
    direction (above hidden 128: the cluster routes up to 512 where
    ``forward_route`` and ``backward_route`` take them, streaming
    otherwise)."""
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=0)
    k_leaves = [x.clone().requires_grad_() for x in ins]
    p_leaves = [x.clone().requires_grad_() for x in ins]
    before = dict(gru_kernel.LAUNCHES)
    hs_k = gru_kernel.GRUScan.apply(*k_leaves, resets)
    hs_p = gru_ref.gru_scan(*p_leaves, resets)
    assert_close_scaled(hs_k, hs_p, GRU_TOL)
    for gk, gp in zip(torch.autograd.grad(hs_k, k_leaves, g),
                      torch.autograd.grad(hs_p, p_leaves, g)):
        assert_close_scaled(gk, gp, GRU_TOL)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    fwd = gru_kernel.forward_route((a, t, b, h), sms, _max_active())
    bwd = gru_kernel.backward_route((a, t, b, h), sms,
                                    _max_active("backward"))
    assert {k: gru_kernel.LAUNCHES[k] - before[k] for k in before} == {
        "gru_forward": 1, "gru_backward": 1,
        "gru_forward_stream": int(fwd == "stream"),
        "gru_forward_cluster": int(fwd == "cluster"),
        "gru_backward_stream": int(bwd == "stream"),
        "gru_backward_cluster": int(bwd == "cluster")}


def _odd(x):
    """A contiguous copy of x at an odd float offset (not 16-byte
    aligned)."""
    flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("resets_on", [False, True])
@pytest.mark.parametrize("a,t,b,h", [
    (3, 6, 70, 160),      # 5 CTAs, two tiles of 64 rows, the last ragged
    (2, 7, 37, 256),      # 8 CTAs, 37 rows in a tile of 64
    (100, 7, 128, 256),   # the AIP's training batch
    (2, 5, 19, 384),      # 12 CTAs, tiles of 16 rows
    (2, 9, 13, 512),      # 16 CTAs, tiles of 8 rows
    (3, 4, 21, 200),      # 7 CTAs, units past the hidden in the last
    (16, 16, 64, 512)])   # the policy-like wide shape
def test_gru_cluster_chain_matches_plain(cuda_device, a, t, b, h,
                                         resets_on):
    """The backward on ``gru_bwd_chain_cluster`` against the plain
    version's autograd, with resets on and off, batches no multiple of
    the tile; one launch counted on the cluster route."""
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=7,
                                 reset_p=0.2 if resets_on else 0.0)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert gru_kernel.backward_route((a, t, b, h), sms,
                                     _max_active("backward")) == "cluster"
    hs = gru_kernel.forward(*ins, resets)
    before = gru_kernel.LAUNCHES["gru_backward_cluster"]
    got = gru_kernel.backward(*ins, resets, hs, g)
    assert gru_kernel.LAUNCHES["gru_backward_cluster"] == before + 1
    leaves = [x.clone().requires_grad_() for x in ins]
    want = torch.autograd.grad(gru_ref.gru_scan(*leaves, resets), leaves, g)
    for k, p in zip(got, want):
        assert_close_scaled(k, p, GRU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(3, 9, 20, 256), (2, 8, 8, 512),
                                     (100, 7, 128, 256), (3, 5, 16, 384),
                                     (2, 4, 5, 160)])
def test_gru_cluster_chain_is_deterministic(cuda_device, a, t, b, h):
    """The cluster chain sums in a fixed order (a lane's columns, the
    fold's shuffle tree, the slots in rank order): two runs give the same
    bits; its plan's shared memory is the wrapper's and the card holds at
    least one cluster of it at once."""
    from repro_torch.kernels import build
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=8)
    hs = gru_kernel.forward(*ins, resets)
    first = gru_kernel.backward(*ins, resets, hs, g)
    second = gru_kernel.backward(*ins, resets, hs, g)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ctas, rows = gru_kernel.cluster_plan(h, b, a, sms, "backward")
    ext = build.extension()
    assert ext.gru_backward_cluster_smem_bytes(h, ctas, rows) == \
        gru_kernel.cluster_chain_smem_bytes(h, ctas, rows)
    assert ext.gru_backward_cluster_max_active(h, ctas, rows) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(3, 9, 20, 256), (2, 8, 8, 512),
                                     (2, 4, 5, 160), (2, 5, 7, 300),
                                     (2, 5, 19, 384)])
def test_gru_cluster_chain_takes_unaligned_views(cuda_device, a, t, b, h):
    """The cluster chain copies W_h with 16-byte copies only where the
    tensor starts 16-byte aligned: views at an odd float offset give the
    same bits as aligned copies, and match the plain version."""
    ins, resets, g = _gru_inputs(cuda_device, a, t, b, h, seed=9)
    hs = gru_kernel.forward(*ins, resets)
    gi, wh, bh, h0 = ins
    before = gru_kernel.LAUNCHES["gru_backward_cluster"]
    got = gru_kernel.backward(_odd(gi), _odd(wh), bh, _odd(h0), resets,
                              _odd(hs), _odd(g))
    assert gru_kernel.LAUNCHES["gru_backward_cluster"] == before + 1
    for x, y in zip(got, gru_kernel.backward(*ins, resets, hs, g)):
        assert torch.equal(x, y)
    leaves = [x.clone().requires_grad_() for x in ins]
    want = torch.autograd.grad(gru_ref.gru_scan(*leaves, resets), leaves, g)
    for k, p in zip(got, want):
        assert_close_scaled(k, p, GRU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(3, 9, 20, 256), (2, 8, 8, 512),
                                     (100, 7, 128, 256), (3, 1, 16, 384)])
def test_gru_cluster_forward_is_deterministic(cuda_device, a, t, b, h):
    """The cluster forward sums each gate in a fixed order (a lane's
    chunks in turn, then a fixed shuffle tree), so two runs give the same
    bits; its plan fits a block and the card holds at least one cluster
    of it at once."""
    from repro_torch.kernels import build
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert gru_kernel.forward_route((a, t, b, h), sms,
                                    _max_active()) == "cluster"
    ins, resets, _ = _gru_inputs(cuda_device, a, t, b, h, seed=5)
    first = gru_kernel.forward(*ins, resets)
    second = gru_kernel.forward(*ins, resets)
    assert torch.equal(first, second)
    ctas, rows = gru_kernel.cluster_plan(h, b, a, sms)
    ext = build.extension()
    assert ext.gru_forward_cluster_smem_bytes(h, ctas, rows) == \
        gru_kernel.cluster_smem_bytes(h, rows)
    assert ext.gru_forward_cluster_max_active(h, ctas, rows) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(3, 9, 20, 256), (2, 8, 8, 512),
                                     (2, 4, 5, 160)])
def test_gru_cluster_forward_takes_unaligned_views(cuda_device, a, t, b, h):
    """The cluster forward reads W_h and h0 with 16-byte copies only where
    the tensor starts 16-byte aligned: contiguous views at an odd float
    offset give the same bits as aligned copies of them, and match the
    plain version."""
    ins, resets, _ = _gru_inputs(cuda_device, a, t, b, h, seed=6)

    def odd(x):
        flat = torch.empty(x.numel() + 1, device=cuda_device)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    gi, wh, bh, h0 = ins
    before = gru_kernel.LAUNCHES["gru_forward_cluster"]
    got = gru_kernel.forward(gi, odd(wh), bh, odd(h0), resets)
    assert gru_kernel.LAUNCHES["gru_forward_cluster"] == before + 1
    assert torch.equal(got, gru_kernel.forward(gi, wh, bh, h0, resets))
    assert_close_scaled(got, gru_ref.gru_scan(gi, wh, bh, h0, resets),
                        GRU_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(4, 12, 40, 64), (2, 20, 24, 128),
                                     (100, 16, 4, 128), (100, 1, 16, 128),
                                     (3, 9, 20, 256), (2, 5, 8, 512)])
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
def test_async_collect_on_card(cuda_device):
    """The overlapped GS collect on the card (warehouse side 2, the GRU
    policy and AIP, kernels on, 3 rounds): ``max_aip_staleness=0`` is the
    serial run bit for bit; with the bound 2 the tags lag one round, the
    collect worker launches ``gru_fwd`` on a stream other than the
    driver's, and two runs agree bit for bit."""
    from repro_torch import random as R
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    from repro_torch.tree import leaves

    def run(**kw):
        mod, cfg = registry.make("warehouse", side=2, horizon=16)
        info = cfg.info()
        tr = dials.DIALSTrainer(
            mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions,
                                          kind="gru", hidden=(16,),
                                          gru_hidden=8),
            influence.AIPConfig(info.alsh_dim, info.n_influence, kind="gru",
                                hidden=(16,), gru_hidden=8, epochs=3,
                                batch=4),
            ppo.PPOConfig(epochs=1, minibatches=2),
            dials.DIALSConfig(outer_rounds=3, aip_refresh=2, collect_envs=4,
                              collect_steps=16, n_envs=4, rollout_steps=8,
                              eval_episodes=2, use_kernels="on", **kw),
            device=cuda_device)
        state, hist = tr.run(R.key(0, cuda_device))
        return leaves(state["ials"]) + leaves(state["aips"]), hist

    def same(a, b):
        keys = ("gs_return", "aip_ce_before", "aip_ce_after",
                "ials_reward", "data_round")
        return (all(x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(a[0], b[0]))
                and [[r[k] for k in keys] for r in a[1]]
                == [[r[k] for k in keys] for r in b[1]])

    for tbl in gru_kernel.STREAM_LAUNCHES.values():
        tbl.clear()
    serial = run()
    driver = torch.cuda.current_stream(cuda_device).cuda_stream
    assert set(gru_kernel.STREAM_LAUNCHES["gru_forward"]) == {driver}
    zero = run(async_collect=True, max_aip_staleness=0)
    assert [r["forced_sync"] for r in zero[1]] == [True] * 3
    assert same(serial, zero)
    for tbl in gru_kernel.STREAM_LAUNCHES.values():
        tbl.clear()
    lagged = [run(async_collect=True) for _ in range(2)]
    assert [r["data_round"] for r in lagged[0][1]] == [0, 0, 1]
    side = {s: n for s, n in
            gru_kernel.STREAM_LAUNCHES["gru_forward"].items() if s != driver}
    assert sum(side.values()) > 0, gru_kernel.STREAM_LAUNCHES
    assert same(*lagged)


def _contract_programs(device, env, kind):
    """The loop driver's four programs of the contracts phase at side 2,
    kernels on, narrow widths (the GRU AIP), by short name."""
    from repro_torch.analysis import programs
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    mod, cfg = registry.make(env, side=2, horizon=16)
    info = cfg.info()
    tr = dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions,
                                      kind=kind, hidden=(16,), gru_hidden=8),
        influence.AIPConfig(info.alsh_dim, info.n_influence, kind="gru",
                            hidden=(16,), gru_hidden=8, epochs=3, batch=4),
        ppo.PPOConfig(epochs=1, minibatches=2),
        dials.DIALSConfig(aip_refresh=2, collect_envs=4, collect_steps=16,
                          n_envs=4, rollout_steps=8, eval_episodes=2,
                          use_kernels="on"),
        device=device)
    return {p.name.rsplit("/", 1)[1]: p
            for p in programs.loop_programs(env, trainer=tr)}


def _sharded_card_trainer(device, **kw):
    from repro_torch.analysis import programs
    return programs.tiny_trainer("warehouse", kind="gru", device=device,
                                 **kw)


def _sharded_card_rank():
    """One of two ranks sharing cuda:0 over gloo (``spawn_local``): the
    tiny recurrent-policy warehouse with ``shards=2`` and kernels on, its
    collect against the replicated collect's rows, the round's contracts
    and every collective wrapper on a CUDA tensor (gloo carries the
    reductions, gathers and broadcasts on the card itself; the ring shift
    stages through pinned host buffers, gloo's point-to-point calls
    failing on CUDA tensors)."""
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap, collectives
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.tree import leaves
    ctx = bootstrap.bootstrap()
    device = torch.device("cuda", 0)
    tr = _sharded_card_trainer(device, shards=2, use_kernels="on")
    state, history = tr.run(R.key(0, device))
    runner = tr._sharded
    init = tr.init(R.key(0, device))
    carry = runner.shard_carry(
        {"aips": init["aips"], "ials": init["ials"],
         "reports": torch.zeros(tr.info.n_agents, dtype=torch.int64,
                                device=device)})
    mine = runner.collect(carry["ials"]["params"], R.key(5, device))
    full = tr.collect(init["ials"]["params"], R.key(5, device))
    runner.audit_collectives(carry, R.key(0, device))
    mesh = runner.mesh
    x = torch.arange(4.0, device=device) + 10 * ctx.process_id
    coll = {"psum": collectives.tree_psum(x, mesh),
            "pmean": collectives.tree_pmean(x, mesh),
            "gather": collectives.tree_all_gather(x[None], mesh),
            "scatter": collectives.tree_psum_scatter(x, mesh),
            "bcast": collectives.pbroadcast(x, mesh, root=1),
            "ring": collectives.ppermute_ring(x, mesh, shift=1)}
    return {"rank": ctx.process_id, "history": history,
            "coll": {k: (str(v.device), v.cpu()) for k, v in coll.items()},
            "use_sharded_gs": runner.use_sharded_gs,
            "collect_equal": all(torch.equal(mine[k], full[k][runner.rows])
                                 for k in full),
            "staged": collectives.STATS["staged_bytes"],
            "gru_forward": gk.LAUNCHES["gru_forward"],
            "aips": leaves(state["aips"]),
            "params": leaves(state["ials"]["params"])}


@pytest.mark.cuda
def test_one_shard_runner_kernels_on_vs_off(cuda_device):
    """The one-shard sharded round on the card through the kernels
    against the plain versions from the same seed (AIP params 1e-5,
    policy params 1e-4, held-out CE 1e-5: the reference's kernel-vs-
    oracle check on its mesh), and against the loop driver bit for bit."""
    from repro_torch import random as R
    from repro_torch.tree import leaves
    runs = {}
    for mode in ("on", "off"):
        tr = _sharded_card_trainer(cuda_device, use_kernels=mode)
        runs[mode] = tr._run_sharded(tr.init(R.key(0, cuda_device)), 1,
                                     log=None, straggler_mask=None)
        assert tr._sharded.use_sharded_gs
    loop = _sharded_card_trainer(cuda_device, use_kernels="on").run(
        R.key(0, cuda_device))
    (s_on, h_on), (s_off, h_off) = runs["on"], runs["off"]
    for a, b in zip(leaves(s_on["aips"]), leaves(s_off["aips"])):
        assert_close_scaled(a, b, 1e-5)
    for a, b in zip(leaves(s_on["ials"]["params"]),
                    leaves(s_off["ials"]["params"])):
        assert float((a - b).abs().max()) <= 1e-4
    for r1, r2 in zip(h_on, h_off):
        for k in ("aip_ce_before", "aip_ce_after"):
            assert abs(r1[k] - r2[k]) <= 1e-5, k
    for a, b in zip(leaves(s_on), leaves(loop[0])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_two_ranks_on_card_match_loop(cuda_device):
    """Two ranks share cuda:0 over gloo: the halo exchange stages
    through pinned host buffers, each rank's collect is the replicated
    collect's rows bit for bit, the contracts hold, every collective
    wrapper gives the exact sums, gathers and shifts on CUDA tensors, and
    rank 0's records and state match the loop driver on the card (AIP
    1e-6, CE and IALS reward 1e-5, GS return 5e-2; policy 1e-2 and
    nearer the loop's than half the loop's own move from init)."""
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap
    from repro_torch.tree import leaves
    outs = bootstrap.spawn_local(2, _sharded_card_rank, timeout_s=600)
    tr = _sharded_card_trainer(cuda_device, use_kernels="on")
    init = leaves(tr.init(R.key(0, cuda_device))["ials"]["params"])
    loop_state, loop_hist = tr.run(R.key(0, cuda_device))
    xs = [torch.arange(4.0) + 10 * r for r in range(2)]
    total = xs[0] + xs[1]
    for o in outs:
        assert o["use_sharded_gs"] and o["collect_equal"], o["rank"]
        assert o["staged"] > 0 and o["gru_forward"] > 0
        r = o["rank"]
        want = {"psum": total, "pmean": total / 2,
                "gather": torch.stack(xs), "scatter": total[2 * r:2 * r + 2],
                "bcast": xs[1], "ring": xs[1 - r]}
        for k, v in want.items():
            dev, got = o["coll"][k]
            assert dev.startswith("cuda"), (r, k, dev)
            assert torch.equal(torch.as_tensor(got), v), (r, k, got)
    for part, want, tol in (("aips", loop_state["aips"], 1e-6),
                            ("params", loop_state["ials"]["params"], 1e-2)):
        err = max(float((torch.as_tensor(a) - b.cpu()).abs().max())
                  for a, b in zip(outs[0][part], leaves(want)))
        assert err <= tol, (part, err)

    def flat(xs):
        return torch.cat([torch.as_tensor(x).double().cpu().reshape(-1)
                          for x in xs])
    loop_p = flat(leaves(loop_state["ials"]["params"]))
    rel = float((flat(outs[0]["params"]) - loop_p).norm()
                / (loop_p - flat(init)).norm())
    assert rel <= 0.5, rel
    for rec, ref in zip(outs[0]["history"], loop_hist):
        for k, tol in (("aip_ce_before", 1e-5), ("aip_ce_after", 1e-5),
                       ("ials_reward", 1e-5), ("gs_return", 5e-2)):
            assert abs(rec[k] - ref[k]) <= tol, k


def _card_state(device, n=4):
    g = torch.Generator().manual_seed(0)
    return {"ials": {"w": torch.randn(n, 3, generator=g).to(device),
                     "n": torch.arange(n).to(device)},
            "aips": {"b": torch.randn(n, 2, generator=g).to(device)
                     .to(torch.bfloat16)},
            "round": 3, "key": torch.tensor([7, 11], device=device)}


def _ckpt_card_rank(directory):
    """One of two ranks sharing cuda:0: saves its block of a CUDA state
    in the distributed layout (rank 0 commits), then restores its block
    onto its mesh and the whole state."""
    from repro_torch.checkpoint import distributed as dckpt
    from repro_torch.distributed import bootstrap, collectives, runtime
    from repro_torch.tree import leaves
    bootstrap.bootstrap()
    device = torch.device("cuda", 0)
    state = _card_state(device)
    mesh = runtime.shard_mesh(device=device)
    mgr = dckpt.DistributedCheckpointManager(
        directory, process_id=mesh.rank, async_write=mesh.rank == 0)
    # a manager cleans the prepares it finds: both exist before a save
    collectives.tree_psum(torch.zeros(1, device=device), mesh)
    block = {**state, **runtime.shard_agent_tree(
        {"ials": state["ials"], "aips": state["aips"]}, mesh)}
    mgr.save(3, block, extra={"reports": [2] * 4}, mesh=mesh)
    mgr.wait()
    collectives.tree_psum(torch.zeros(1, device=device), mesh)  # barrier
    target = {k: (torch.zeros_like(v) if torch.is_tensor(v) else v)
              for k, v in _card_state(device).items()}
    target = {**target, "ials": {k: torch.zeros_like(v) for k, v in
                                 state["ials"].items()},
              "aips": {k: torch.zeros_like(v) for k, v in
                       state["aips"].items()}, "round": 0}
    mine, step = mgr.restore_latest(target, mesh=mesh)
    whole, _ = mgr.restore_latest(target)
    return {"step": step, "extra": mgr.last_extra,
            "block_equal": all(a.device.type == "cuda" and torch.equal(a, b)
                               for a, b in zip(leaves(mine), leaves(block))
                               if torch.is_tensor(a)),
            "whole_equal": all(torch.equal(a, b) for a, b in
                               zip(leaves(whole), leaves(state))
                               if torch.is_tensor(a)),
            "round": whole["round"]}


@pytest.mark.cuda
def test_two_rank_distributed_checkpoint_on_card(cuda_device, tmp_path):
    """Two ranks sharing cuda:0 save one step in the reference's layout
    (one slice each, rank 0 commits) and restore it exactly: each rank
    its block onto its mesh, the whole state, and this process the step
    onto one shard of the card."""
    import os
    from repro_torch.checkpoint import distributed as dckpt
    from repro_torch.distributed import bootstrap, runtime
    from repro_torch.tree import leaves
    d = str(tmp_path / "ck")
    outs = bootstrap.spawn_local(2, _ckpt_card_rank, d, timeout_s=300)
    for o in outs:
        assert o["step"] == 3 and o["round"] == 3, o
        assert o["block_equal"] and o["whole_equal"], o
        assert o["extra"] == {"reports": [2] * 4}
    step = os.path.join(d, "step_3")
    assert sorted(os.listdir(step)) == [
        "COMMIT", "agents-00000-00002", "agents-00002-00004", "replicated"]
    state = _card_state(cuda_device)
    one = runtime.ShardMesh(n_shards=1, rank=0, device=cuda_device)
    back, _ = dckpt.read_step_mesh(step, state, one)
    assert all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in zip(leaves(back),
                                                    leaves(state))
               if torch.is_tensor(a))


def _reshard_card_rank(directory):
    """One of two ranks sharing cuda:0: the resume path's programs
    (``recovery_programs``) on the card under the communication rules,
    and a re-shard transfer that all-reduces a CUDA tensor."""
    from repro_torch.analysis import contracts, programs
    from repro_torch.distributed import bootstrap
    bootstrap.bootstrap()
    device = torch.device("cuda", 0)
    progs = programs.recovery_programs("traffic", device=device,
                                       directory=directory)
    findings = contracts.run_rules(progs, rules=(
        contracts.CollectiveFree(), contracts.HaloOnly(),
        contracts.ReshardCollectives()))

    def summing(v):
        y = v.clone()
        torch.distributed.all_reduce(y)
        return y

    leaky = contracts.ReshardCollectives().check(contracts.Program(
        "card/reshard-allreduce", ("reshard",), summing,
        (torch.ones(4, device=device),)))
    fetch = [p for p in progs if p.name.endswith("reshard_fetch")][0]
    return {"names": [p.name for p in progs],
            "findings": [f.message for f in findings],
            "leaky": [f.message for f in leaky],
            "fetch_ops": sorted({s.op for s in fetch.recording().sites
                                 if s.op.startswith("c10d")})}


@pytest.mark.cuda
def test_reshard_collectives_on_card(cuda_device, tmp_path):
    """``ReshardCollectives`` on the card's two re-shard transfers (two
    ranks on cuda:0): the checkpoint rows to this shard's placement and
    ``fetch_tree`` dispatch data movement only (the fetch an all-gather);
    an all-reduce in a re-shard transfer is flagged."""
    from repro_torch.distributed import bootstrap
    outs = bootstrap.spawn_local(2, _reshard_card_rank, str(tmp_path),
                                 timeout_s=600)
    for o in outs:
        assert o["findings"] == [], o["findings"]
        assert any(n.endswith("reshard_place") for n in o["names"])
        assert any(op.startswith("c10d.allgather") or
                   op.startswith("c10d._allgather") for op in o["fetch_ops"])
        assert o["leaky"] and "allreduce" in o["leaky"][0], o["leaky"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kill", "stall"])
def test_peer_failure_markers_on_card(cuda_device, mode):
    """A two-rank group reducing CUDA tensors on cuda:0, broken by a
    killed or a stalled peer (``tests/_torch_peer_check.py``): the error
    the survivor gets reads as a peer failure."""
    import os
    import _torch_procs as procs
    peer = os.path.join(procs.ROOT, "tests", "_torch_peer_check.py")
    (rc0, log0), (rc1, _) = procs.wait_all(procs.launch(
        peer, ["--mode", mode, "--device", "cuda"]), timeout=300)
    assert rc0 == 0, log0[-2000:]
    assert rc1 == (-9 if mode == "kill" else 0)
    assert "PEER-ERROR none" not in log0, log0[-2000:]
    assert "PEER-FAILURE True" in log0, log0[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("env,kind", [("warehouse", "gru"),
                                      ("traffic", "fnn")])
def test_contracts_no_host_sync_on_card(cuda_device, env, kind):
    """``NoHostSync`` with nothing exempt and one call under
    ``set_sync_debug_mode("error")``, for the ring collect, the AIP round,
    the inner step and the GS eval, kernels on."""
    from repro_torch.analysis import contracts, report
    progs = _contract_programs(cuda_device, env, kind)
    for name in ("ring_collect", "aip_round", "ials_train", "gs_eval"):
        found = contracts.NoHostSync().check(progs[name])
        assert found == [], "\n".join(report.format_finding(f)
                                       for f in found)


@pytest.mark.cuda
@pytest.mark.parametrize("env,kind", [("warehouse", "gru"),
                                      ("traffic", "fnn")])
def test_contracts_graph_capture_on_card(cuda_device, env, kind):
    """``GraphCapturable`` for the inner step and the AIP round: captured
    as one CUDA graph with the GRU and GAE kernels inside, one replay and
    three replays (state fed back) bit for bit the eager calls."""
    from repro_torch.analysis import contracts, report
    from repro_torch.kernels.gae import kernel as gae_k
    progs = _contract_programs(cuda_device, env, kind)
    for name in ("ials_train", "aip_round"):
        program = progs[name]
        program.meta["replays"] = 3
        before = {**gru_kernel.LAUNCHES, **gae_k.LAUNCHES}
        found = contracts.GraphCapturable().check(program)
        assert found == [], "\n".join(report.format_finding(f)
                                       for f in found)
        after = {**gru_kernel.LAUNCHES, **gae_k.LAUNCHES}
        # 3 eager calls and the capture launch; replays count nothing
        assert (after["gru_forward"] - before["gru_forward"]) % 4 == 0
        assert after["gru_forward"] > before["gru_forward"]
        if name == "ials_train":
            assert after["gae_forward"] - before["gae_forward"] == 4
        timing = program.meta["timing"]
        assert len(timing["eager_ms"]) == len(timing["replay_ms"]) == 3


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
    # the chain's dgh and adjoint (4 R H floats) overflow shared memory
    # above H=7,264 even at 2 rows a tile
    hd = 7265
    z = lambda *s: torch.zeros(*s, device=cuda_device)
    with pytest.raises(ValueError, match=f"shared memory at hidden {hd}"):
        gru_kernel.backward(z(1, 2, 3, 3 * hd), z(1, hd, 3 * hd),
                            z(1, 3 * hd), z(1, 3, hd), resets, z(1, 2, 3, hd),
                            z(1, 2, 3, hd))
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


def _launched(kernel):
    """The launch counts' change that one launch on ``kernel`` makes."""
    return {"flash_attention": 1,
            **{r: int(r == kernel) for r in fa_kernel.ROUTES}}


@pytest.mark.cuda
def test_flash_routes_by_dtype(cuda_device):
    """bf16 goes to the tensor-core kernel and float32 to the FFMA kernel,
    which still holds the reference's 2e-5, as ``route`` names them;
    each launch counts once in ``flash_attention`` and once under its
    kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(4, 192, 128, generator=gen, device=cuda_device)
               for _ in range(3))
    kw = dict(causal=True, sliding_window=70, softcap=50.0)
    f32, bf16 = (fa_kernel.route(dt, 128)
                 for dt in (torch.float32, torch.bfloat16))
    assert (f32, bf16) == ("flash_fwd", "flash_fwd_sm90")
    counts = dict(fa_kernel.LAUNCHES)
    out = fa_kernel.forward(q, k, v, **kw)
    assert_allclose(out, fa_ref.attention_bhsd(q, k, v, **kw),
                    FLASH_TOL[torch.float32])
    assert {k: fa_kernel.LAUNCHES[k] - counts[k] for k in counts} == \
        _launched(f32)
    counts = dict(fa_kernel.LAUNCHES)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = fa_kernel.forward(qb, kb, vb, **kw)
    assert out.dtype == torch.bfloat16
    assert {k: fa_kernel.LAUNCHES[k] - counts[k] for k in counts} == \
        _launched(bf16)
    # a view that is not 16-byte aligned cannot feed the tensor maps
    flat = torch.zeros(4 * 192 * 128 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    odd = flat[1:].view(4, 192, 128)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.forward(odd, kb, vb, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bhkv,t,d,window,softcap,causal", [
    (4, 2, 200, 16, 64, 50.0, True),       # the reduced configs' head_dim
    (4, 2, 130, 80, None, 30.0, True),     # padded to 128
    (4, 4, 300, 96, 17, 50.0, True),       # window under a key tile
    (2, 1, 257, 192, 100, None, True),     # the 192 case, MQA
    (4, 2, 200, 320, 64, 50.0, True),      # 32-row tiles, padded to 384
    (2, 2, 150, 512, None, 50.0, False),   # the widest, non-causal
    (2, 1, 70, 1, None, None, True),       # a head_dim of one
])
def test_flash_ffma_head_dims_match_plain(cuda_device, dtype, bh, bhkv, t,
                                          d, window, softcap, causal):
    """Head_dims outside the tensor-core kernel's 64/128/256: float32
    and bf16 above 256 on the FFMA kernel ``flash_fwd_padded`` (bf16
    widened as it loads), bf16 up to 256 on ``flash_fwd_sm90_padded``, as
    ``route`` names them, against the plain version in float32 on the
    same inputs: FLASH_TOL in float32; in bf16 only p's split, the
    output's rounding (2^-8 relative) and the order of float32 sums
    differ, FLASH_BF16_F32_TOL."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    q, k, v = (rnd(bh, t, d) * 3).to(dtype), (rnd(bhkv, t, d) * 3).to(dtype), \
        rnd(bhkv, t, d).to(dtype)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    kernel = fa_kernel.route(dtype, d)
    assert kernel == ("flash_fwd_sm90_padded" if dtype == torch.bfloat16
                      and d <= 256 else "flash_fwd_padded")
    before = dict(fa_kernel.LAUNCHES)
    out = fa_kernel.forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {k: fa_kernel.LAUNCHES[k] - before[k] for k in before} == \
        _launched(kernel)
    assert out.dtype == dtype and out.shape == q.shape
    want = fa_ref.attention_bhsd(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.float32:
        assert_allclose(out, want, FLASH_TOL[dtype])
    else:
        atol, rtol = FLASH_BF16_F32_TOL
        diff = (out.double() - want.double()).abs()
        assert not bool((diff > atol + rtol * want.double().abs()).any()), \
            f"max abs err {float(diff.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_96_at_t4096(cuda_device, dtype):
    """A full-width prompt at head_dim 96: B=1, 8 heads over 2 KV heads,
    T=4,096, causal with window 1,024 and softcap 50, through the op."""
    gen = torch.Generator(device=cuda_device).manual_seed(96)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    q, k, v = (rnd(1, 4096, 8, 96) * 3).to(dtype), \
        (rnd(1, 4096, 2, 96) * 3).to(dtype), rnd(1, 4096, 2, 96).to(dtype)
    kw = dict(causal=True, sliding_window=1024, softcap=50.0)
    kernel = fa_kernel.route(dtype, 96)
    before = fa_kernel.LAUNCHES[kernel]
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_kernel.LAUNCHES[kernel] == before + 1
    want = fa_ref.attention(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.float32:
        assert_allclose(out, want, FLASH_TOL[dtype])
    else:
        atol, rtol = FLASH_BF16_F32_TOL
        diff = (out.double() - want.double()).abs()
        assert not bool((diff > atol + rtol * want.double().abs()).any()), \
            f"max abs err {float(diff.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("bh,bhkv,t,d,window,softcap,causal", [
    (4, 2, 300, 20, 64, 50.0, True),       # d % 8 != 0: rows padded to 24
    (2, 1, 129, 1, None, None, True),      # a head_dim of one, MQA
    (4, 2, 200, 100, None, 30.0, False),   # d % 8 != 0, padded to 128
    (4, 2, 257, 200, 100, 50.0, True),     # DP 256, window
    (4, 4, 190, 250, 17, 50.0, True),      # d % 8 != 0 at DP 256
    (8, 2, 4100, 16, 32, 50.0, True),      # the reduced configs', long
    (4, 2, 330, 136, None, None, True),    # DP 192, causal only
])
def test_flash_sm90_padded_matches_plain_in_float32(
        cuda_device, bh, bhkv, t, d, window, softcap, causal):
    """``flash_fwd_sm90_padded`` on bf16 inputs, q scaled by 8 so a few
    keys lead each softmax and the scores reach the softcap, against the
    plain version in float32 on the same inputs (FLASH_BF16_F32_TOL): the
    zero columns past d, the rows padded to 8 and the output's row stride
    d move no output."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    q = (rnd(bh, t, d) * 8).bfloat16()
    k, v = rnd(bhkv, t, d).bfloat16(), rnd(bhkv, t, d).bfloat16()
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    assert fa_kernel.route(torch.bfloat16, d) == "flash_fwd_sm90_padded"
    before = dict(fa_kernel.LAUNCHES)
    out = fa_kernel.forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {k: fa_kernel.LAUNCHES[k] - before[k] for k in before} == \
        _launched("flash_fwd_sm90_padded")
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = fa_ref.attention_bhsd(q.float(), k.float(), v.float(), **kw)
    atol, rtol = FLASH_BF16_F32_TOL
    diff = (out.double() - want.double()).abs()
    bad = diff > atol + rtol * want.double().abs()
    assert not bool(bad.any()), \
        f"max abs err {float(diff.max()):.3e} at rows " \
        f"{bad.any(-1).nonzero()[:4].tolist()}"


@pytest.mark.cuda
def test_flash_sm90_padded_alignment(cuda_device):
    """At d % 8 == 0 the tensor maps read q, k, v in place, so a view
    that is not 16-byte aligned raises; at d % 8 != 0 the rows are copied
    into aligned scratch first, and the same view runs."""
    kw = dict(causal=True, sliding_window=70, softcap=50.0)
    for d in (96, 36):
        flat = torch.randn(4 * 192 * d + 1, device=cuda_device).bfloat16()
        odd = flat[1:].view(4, 192, d)
        k, v = odd[:2].clone(), odd[2:].clone()
        if d % 8 == 0:
            with pytest.raises(ValueError, match="aligned"):
                fa_kernel.forward(odd, k, v, **kw)
            continue
        out = fa_kernel.forward(odd, k, v, **kw)
        want = fa_ref.attention_bhsd(odd.float(), k.float(), v.float(), **kw)
        atol, rtol = FLASH_BF16_F32_TOL
        diff = (out.double() - want.double()).abs()
        assert not bool((diff > atol + rtol * want.double().abs()).any())


@pytest.mark.cuda
def test_flash_extension_refuses_what_no_route_sends(cuda_device):
    """The FFMA kernel has no bf16 instantiation at head_dim <= 256 (the
    tensor-core route takes those), and the padded tensor-core binding
    refuses scratch rows that are not q, k, v's padded to 8."""
    from repro_torch.kernels import build
    ext = build.extension()
    q = torch.randn(2, 64, 96, device=cuda_device).bfloat16()
    with pytest.raises(RuntimeError):
        ext.flash_attention(q, q, q, torch.empty_like(q), True, 0, 0.0, 0.1)
    q = torch.randn(2, 64, 36, device=cuda_device).bfloat16()
    short = torch.empty(2, 64, 36, device=cuda_device).bfloat16()
    with pytest.raises(RuntimeError, match="rounded up to 8"):
        ext.flash_attention_sm90_padded(q, q, q, torch.empty_like(q), short,
                                        short, short, True, 0, 0.0, 0.1)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 512, 2, 6, 6, 256),          # chunk 256, P = N = 6
    (2, 768, 3, 6, 6, 256),
    (1, 96, 4, 8, 12, 24),           # a chunk no multiple of 16
    (1, 256, 2, 256, 256, 64),       # P and N of 256
    (1, 500, 3, 5, 7, 100),          # odd everything
    (2, 8192, 48, 64, 128, 256),     # mamba2-780m's widths at chunk 256
])
def test_ssd_tiled_matches_plain(cuda_device, dtype, b, t, h, p, n, chunk):
    """``ssd_chunk_tiled`` (any chunk, P, N) against the plain intra-chunk
    block, and ``ops.ssd`` with an initial state against ``ssd_chunked``;
    the tolerances of test_ssd_kernel_matches_plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, dt, a, bm, c = _ssd_inputs(gen, cuda_device, b, t, h, p, n, dtype)
    xw = (x * dt[..., None].to(dtype)).contiguous()
    la = (dt * a).contiguous()
    # bf16 at P 64, N 64/128, chunk 256 goes to the long tensor-core route
    key = ("ssd_chunk_sm90_long" if dtype == torch.bfloat16 and p == 64
           and n in (64, 128) and chunk == 256 else "ssd_chunk_tiled")
    assert ssd_kernel.route(dtype, p, n, chunk) == key
    before = dict(ssd_kernel.LAUNCHES)
    got = ssd_kernel.forward(xw, la, bm, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES[key] == before[key] + 1
    want = ssd_ref.intra_chunk(xw, la, bm, c, chunk=chunk)
    tol = SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL
    assert got[0].dtype == dtype
    assert_close_scaled(got[0], want[0], tol)
    for g, w in zip(got[1:], want[1:]):
        assert_close_scaled(g, w, SSD_TOL)
    s0 = torch.randn(b, h, p, n, generator=gen, device=cuda_device)
    y_k, s_k = ssd_ops.ssd(x, dt, a, bm, c, chunk=chunk, initial_state=s0)
    y_p, s_p = ssm_mod.ssd_chunked(x, dt, a, bm, c, chunk=chunk,
                                   initial_state=s0)
    assert_close_scaled(y_k, y_p, tol)
    assert_close_scaled(s_k, s_p, SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,n", [
    (1, 512, 4, 64), (1, 512, 4, 128),
    (2, 8192, 48, 128),              # mamba2-780m's layer at chunk 256
    (2, 4096, None, 64), (2, 8192, None, 128)])  # a short last head group
def test_ssd_long_matches_plain(cuda_device, b, t, h, n):
    """``ssd_chunk_sm90_long`` (bf16, P 64, chunk 256) against the plain
    intra-chunk block: y within SSD_BF16_TOL, the states and decays within
    SSD_TOL, both times max(1, largest magnitude); ``ops.ssd`` with an
    initial state against ``ssd_chunked``."""
    chunk = 256
    if h is None:   # a head count the block's heads do not divide
        sms = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        h = next(k for k in (13, 11, 17, 19, 23, 7, 5) if k % ssd_kernel.
                 heads_per_block_long(b, t // chunk, k, sms))
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x, dt, a, bm, c = _ssd_inputs(gen, cuda_device, b, t, h, 64, n,
                                  torch.bfloat16)
    xw = (x * dt[..., None].bfloat16()).contiguous()
    la = (dt * a).contiguous()
    assert ssd_kernel.route(torch.bfloat16, 64, n, chunk) == \
        "ssd_chunk_sm90_long"
    before = ssd_kernel.LAUNCHES["ssd_chunk_sm90_long"]
    got = ssd_kernel.forward(xw, la, bm, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd_chunk_sm90_long"] == before + 1
    want = ssd_ref.intra_chunk(xw, la, bm, c, chunk=chunk)
    assert got[0].dtype == torch.bfloat16
    assert_close_scaled(got[0], want[0], SSD_BF16_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert_close_scaled(g, w, SSD_TOL)
    s0 = torch.randn(b, h, 64, n, generator=gen, device=cuda_device)
    y_k, s_k = ssd_ops.ssd(x, dt, a, bm, c, chunk=chunk, initial_state=s0)
    y_p, s_p = ssm_mod.ssd_chunked(x, dt, a, bm, c, chunk=chunk,
                                   initial_state=s0)
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
            "ssd_chunk": int(key == "ssd_chunk"), "ssd_chunk_tiled": 0,
            "ssd_chunk_sm90_long": 0}
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
    wide = torch.zeros(4, 64, 513, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim up to 512"):
        fa_kernel.forward(wide, wide, wide)
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


def _card_layer(ls, dtype):
    """A reduced LayerSpec in ``dtype`` with its attention widened to
    head_dim 64, where bf16 takes the tensor-core kernel and float32
    ``flash_fwd`` (the reduced configs' 16 goes to ``flash_fwd_padded``,
    held by test_flash_ffma_head_dims_match_plain and chip_smoke.py's
    reduced gemma2-9b)."""
    subs = {name: dataclasses.replace(getattr(ls, name), dtype=dtype)
            for name in ("attn", "ssm", "mlp", "moe")
            if getattr(ls, name) is not None}
    if ls.attn is not None:
        subs["attn"] = dataclasses.replace(subs["attn"], head_dim=64)
    return dataclasses.replace(ls, dtype=dtype, **subs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,launches", [("granite-moe-1b-a400m", 2),
                                           ("zamba2-1.2b", 1)])
def test_moe_and_hybrid_prefill_flash_matches_plain(cuda_device, arch,
                                                    launches, dtype):
    """One prefill step of reduced granite-moe (two MoE blocks) and
    reduced zamba2 (two SSM blocks and the shared attention block, once)
    with ``use_flash=True`` against the plain prefill, head_dim widened
    to 64, B=2 x T=256: the last logits within 1e-4 (float32, the FFMA
    kernel's 2e-5 through two blocks and the unembedding) or 5e-2
    (bfloat16, the tensor-core kernel; ``chip_smoke.py``'s LOGIT_TOL)
    times max(1, largest magnitude), one flash launch per self-attention
    block, all of the dtype's kernel. The plain run takes the flash run's
    MoE routes (``chip_smoke.RouteLog``): a bf16 rounding difference may
    flip a top-k choice on a near tie, which is not the kernel's fault."""
    import chip_smoke
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    spec = registry.get(arch, reduced=True)
    cfg = spec.cfg
    cfg = dataclasses.replace(
        cfg, dtype=dtype,
        period=tuple(_card_layer(ls, dtype) for ls in cfg.period),
        shared=cfg.shared and _card_layer(cfg.shared, dtype))
    flash = dataclasses.replace(spec, cfg=dataclasses.replace(
        cfg, use_flash=True))
    plain = dataclasses.replace(spec, cfg=dataclasses.replace(
        cfg, use_flash=False))
    params = steps.init_params(flash, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                         device=cuda_device)
    routes = chip_smoke.RouteLog()
    counts = dict(fa_kernel.LAUNCHES)
    with routes.record():
        got = steps.make_prefill_step(flash)(params, {"tokens": toks})
    torch.cuda.synchronize()
    after = dict(fa_kernel.LAUNCHES)
    with routes.replay():
        want = steps.make_prefill_step(plain)(params, {"tokens": toks})
    assert len(routes.routes) == (2 if arch.startswith("granite") else 0)
    kernel = "flash_fwd" if dtype == torch.float32 else "flash_fwd_sm90"
    other = "flash_fwd_sm90" if dtype == torch.float32 else "flash_fwd"
    assert {k: after[k] - counts[k] for k in counts} == {
        "flash_attention": launches, kernel: launches, other: 0,
        "flash_fwd_padded": 0, "flash_fwd_sm90_padded": 0}
    assert fa_kernel.LAUNCHES == after      # the plain prefill: none
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    assert_close_scaled(got, want, 1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_cpu(cuda_device):
    """Reduced tinyllama in float32 on the card and on the CPU, from the
    same parameters and synthetic batches: every gradient leaf, then two
    ``make_train_step`` steps at the shipped schedule (loss, grad norm and
    every leaf of the params and AdamW state), within 1e-4 (relative; of
    each leaf's largest magnitude). A train step launches none of the
    port's kernels."""
    from repro_torch import random as R
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, tree_map
    spec = registry.get("tinyllama-1.1b", reduced=True)
    cfg = spec.cfg
    cfg = dataclasses.replace(
        cfg, dtype=torch.float32,
        period=tuple(_card_layer(ls, torch.float32) for ls in cfg.period))
    spec = dataclasses.replace(spec, cfg=cfg)
    cpu = steps.init_params(spec, seed=0, device="cpu")
    batches = [synthetic.lm_batch(R.fold_in(R.key(1), i), 4, 64, cfg.vocab)
               for i in range(2)]
    counts = lambda: {**fa_kernel.LAUNCHES, **ssd_kernel.LAUNCHES,
                      **gru_kernel.LAUNCHES, **gae_kernel.LAUNCHES}
    before = counts()
    out = {}
    for dev in ("cpu", cuda_device):
        on = lambda tree: tree_map(lambda x: x.to(dev), tree)
        (loss, _), grads = steps.make_value_and_grad(api.loss_fn(spec))(
            on(cpu), on(batches[0]))
        params, opt = on(cpu), adamw.init(on(cpu), per_agent=False)
        step = steps.make_train_step(spec)
        for b in batches:
            params, opt, metrics = step(params, opt, on(b))
        out[str(dev)] = ({**metrics, "grad_loss": loss},
                         (grads, params, opt))
    assert counts() == before
    (mc, tc), (mg, tg) = out["cpu"], out[str(cuda_device)]
    for k in mc:
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(
            1.0, abs(float(mc[k]))), k
    for a, b in zip(leaves(tg), leaves(tc)):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_kernel_bench_fast_passes_the_gate_against_itself(cuda_device,
                                                          tmp_path):
    """``benchmarks/torch_kernels.py --fast`` in process on the card (the
    GRU and GAE wrappers launched, ``gae_backward`` among them), then
    ``benchmarks/torch_check_bench.py`` on its record against itself:
    no finding, exit 0."""
    import json
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import torch_check_bench, torch_kernels
    before = {**gru_kernel.LAUNCHES, **gae_kernel.LAUNCHES}
    out = str(tmp_path / "BENCH_torch_kernels.json")
    assert torch_kernels.main(["--fast", "--out", out]) == 0
    after = {**gru_kernel.LAUNCHES, **gae_kernel.LAUNCHES}
    for name in ("gru_forward", "gru_backward", "gae_forward",
                 "gae_backward"):
        assert after[name] > before[name], name
    with open(out) as f:
        record = json.load(f)
    assert record["fast"] is True and len(record["micro"]) == 7
    assert torch_check_bench.check("kernels", out, out, max_regression=0.25,
                                   subset=False) == []
    assert torch_check_bench.main(["--which", "kernels", "--fresh", out,
                                   "--baseline", out]) == 0


@pytest.mark.cuda
def test_telemetry_report_torch_checks_a_card_run(cuda_device, tmp_path):
    """A two-round DIALS run on the card with telemetry on (warehouse side
    2, kernels on), its event log through ``python -m
    tools.telemetry_report_torch --check`` in a process of its own."""
    import os
    import subprocess
    import sys
    from repro_torch import random as R
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tel = str(tmp_path / "tel")
    mod, cfg = registry.make("warehouse", side=2, horizon=16)
    info = cfg.info()
    dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions),
        influence.AIPConfig(info.alsh_dim, info.n_influence, kind="gru",
                            hidden=(16,), gru_hidden=8, epochs=2, batch=4),
        ppo.PPOConfig(epochs=1, minibatches=2),
        dials.DIALSConfig(outer_rounds=2, aip_refresh=2, collect_envs=4,
                          collect_steps=16, n_envs=4, rollout_steps=8,
                          eval_episodes=2, use_kernels="on",
                          telemetry_dir=tel),
        device=cuda_device).run(R.key(0, cuda_device))
    proc = subprocess.run(
        [sys.executable, "-m", "tools.telemetry_report_torch", tel,
         "--check"], cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# telemetry OK:" in proc.stdout and "2 round records" in \
        proc.stdout


@pytest.mark.cuda
def test_scaling_bench_fast_on_card(cuda_device, tmp_path):
    """``benchmarks/torch_scaling.py --fast`` in process on the card at
    traffic-2x2, shards 1,2, processes 1,2, streams 8 (``chip_smoke.py``'s
    scaling phase): exactly its three rows, each a valid
    ``SCALING_ROW_SCHEMA`` row, and the GAE forward launched by the
    reference cell's inner PPO steps, in process and on each rank of the
    ``-s2-p2`` row (at its (T, B) = (16, 16) block)."""
    import json
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import torch_scaling
    from repro_torch.obs import metrics
    before = gae_kernel.LAUNCHES["gae_forward"]
    out = str(tmp_path / "BENCH_torch_dials_scaling.json")
    assert torch_scaling.main(
        ["--fast", "--scenarios", "traffic-2x2", "--shards", "1,2",
         "--processes", "1,2", "--streams", "8", "--out", out]) == 0
    assert gae_kernel.LAUNCHES["gae_forward"] > before
    with open(out) as f:
        record = json.load(f)
    assert [r["label"] for r in record["rows"]] == [
        "traffic-2x2-s1", "traffic-2x2-s2-p2", "traffic-2x2-streams8"]
    for r in record["rows"]:
        assert metrics.validate_bench_row(
            r, metrics.SCALING_ROW_SCHEMA) == [], r["label"]
    assert record["device"]["platform"] == "gpu"
    # each rank of the -s2-p2 row launched it too, at its own block
    ranks = record["spread"]["traffic-2x2-s2-p2"]["launches_by_rank"]
    assert len(ranks) == 2
    for got in ranks:
        assert got["launches"]["gae_forward"] > 0
        assert "16x16" in got["by_shape"]["gae_forward"]


@pytest.mark.cuda
def test_harness_fig4_on_two_ranks_on_card(cuda_device, tmp_path):
    """``benchmarks/torch_run.py --only fig4_f_sweep --fast --shards 2``:
    the sweep's DIALS cells on two gloo ranks spawned on the card, its
    rows under the reference's labels and keys (``benchmarks/run.py``'s
    fig4_f_sweep), finite, in the JSON and the ``name.label,metric,value``
    lines."""
    import json
    import math
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "benchmarks", "torch_run.py"),
         "--only", "fig4_f_sweep", "--fast", "--shards", "2"],
        cwd=tmp_path, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = json.loads((tmp_path / "experiments" / "bench" /
                       "torch_fig4_f_sweep.json").read_text())
    assert [r["label"] for r in rows] == ["F=2x6", "F=6x2", "F=12x1"]
    for r in rows:
        assert set(r) == {"label", "refresh", "final_gs_return",
                          "aip_ce_final", "wall_s"}
        assert all(math.isfinite(v) for k, v in r.items() if k != "label")
    lines = [ln for ln in out.stdout.splitlines() if not ln.startswith("#")]
    assert lines[0] == "name,metric,value"
    assert lines[1:] == [f"fig4_f_sweep.{r['label']},{k},{v}" for r in rows
                         for k, v in r.items() if k != "label"]


@pytest.mark.cuda
@pytest.mark.parametrize("sharded_gs", ["on", "off"])
def test_harness_fig3_env_rows_on_two_ranks_on_card(cuda_device,
                                                     sharded_gs):
    """``fig3_learning``'s cell for warehouse (one round of F=1) with
    ``--shards 2 --sharded-gs on|off``: the DIALS cells on two gloo ranks
    spawned on the card, the GS collect region-decomposed or replicated;
    the rows carry the reference's labels and keys, finite."""
    import math
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import torch_run
    rows = torch_run.fig3_env_rows("warehouse", rounds=1, inner=1,
                                   shards=2, sharded_gs=sharded_gs,
                                   device=str(cuda_device))
    assert [r["label"] for r in rows] == [
        "DIALS-warehouse", "untrained-DIALS-warehouse", "GS-warehouse"]
    dials_keys = {"label", "final_gs_return", "best_gs_return",
                  "aip_ce_final", "wall_s"}
    assert [set(r) for r in rows] == [dials_keys, dials_keys,
                                      {"label", "final_gs_return", "wall_s"}]
    for r in rows:
        assert all(math.isfinite(v) for k, v in r.items() if k != "label")
