"""Times of one tree's kernels on a GPU, for comparing trees.

For the ``repro_torch`` under ``--src`` (default: this checkout's), prints

* the kernels' times at the shapes their main paths give them, each the
  mean of CUDA events around back-to-back wrapper calls: ``gru_fwd`` and
  the GRU backward at the DIALS AIP's 100x128x7x64 and the recurrent
  policy's 100x16x4x128; ``flash_fwd`` (float32, FFMA) at (16, 2048, 256)
  and ``flash_fwd_sm90`` (bf16) at gemma2-9b's prefill layer, window
  1,024 / 4,096 and softcap 50; ``ssd_chunk`` (float32) and
  ``ssd_chunk_sm90`` (bf16) at mamba2-780m's layer width, chunk 128;
* ``gae_fwd`` and ``gae_bwd`` at the DIALS main path's shape (T=16,
  B=1600: warehouse side=10, 100 agents x 16 envs) and at a long T
  (256 x 1600): the device time per launch, from ``torch.profiler`` over
  200 launches (the kernel's own time), and the host-inclusive time per
  call, from CUDA events around 200 back-to-back wrapper calls (what a
  caller pays; the wrapper's checks, allocation and binding bound it when
  the kernel is short);
* ``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
  (2, 8192, 1536) bf16 activations: the median of 7 synchronised warm
  calls (host clock) and the SSD kernel's device time in one traced call;
* the wide routes: the GRU forward at ``chip_smoke.GRU_WIDE_SHAPES``
  (hidden 256 and 512) and at the rollout cell's T=1 (GRU_CELL_SHAPES),
  and flash attention in bf16 at
  ``chip_smoke.FLASH_FFMA_CASES`` (head_dim 96, 16, 512),
  ``chip_smoke.FLASH_ODD_CASE`` (36) and, at the first case's shape, at
  the head_dims of FLASH_HEAD_DIMS, each with the route its tree's
  ``route`` names, so that two trees that route these shapes to
  different kernels time the old kernel against the new one;
* a digest of the outputs (the first 16 hex digits of the SHA-256 of
  their bytes) of the GRU forward at 100x128x7x64 and of every flash
  launch, so that two trees can be compared bit for bit.

With ``--library`` it instead times, once, the PyTorch calls that compute
the wide flash cases' function (yardsticks, never called by the port):
``scaled_dot_product_attention`` at the causal case and compiled
``flex_attention`` (``chip_smoke.flash_library_ms``) at the cases with a
window or softcap, in both dtypes.

With ``--gru-sweep`` it instead times the GRU forward's two kernels above
hidden 128 on the same inputs, both called past the wrapper's route: the
cluster kernel (``gru_fwd_cluster`` at ``cluster_plan``'s plan) and the
streaming one (``gru_fwd_stream``), over T at one width of each band of
cluster sizes (hidden 160, 256, 384, 512: 5, 8, 12, 16 CTAs) and, at T=1
and 2, on grids of as many clusters as the card holds at once and one
more; beside each, the clusters of the plan the card holds at once and
the route ``forward_route`` takes. That comparison sets
``CLUSTER_MIN_STEPS``.

Each tree builds its kernels into the ``build/`` beside its ``src``. Run
the trees in turns in one call, on one card (parent, change, change,
parent), from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_tree_times.py [--src DIR] [--label NAME]
    python3 benchmarks/torch_tree_times.py --library
    python3 benchmarks/torch_tree_times.py --gru-sweep
"""
from __future__ import annotations

import argparse
import hashlib
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAE_SHAPES = ((16, 1600), (256, 1600))
# the rollout cell (T=1) above hidden 128: 100 agents x 16 envs at 256,
# the wide gru path's 4 agents x 8 envs at 512
GRU_CELL_SHAPES = ((100, 1, 16, 256), (4, 1, 8, 512))
# --gru-sweep: (A, B, H, steps) on grids of many waves: the AIP's training
# batch, the policy-like batch, the rollout cell of 100 agents
GRU_SWEEP = ((100, 128, 160, (1, 2, 4, 8)), (100, 128, 256, (1, 2, 4, 7)),
             (16, 64, 384, (1, 2, 4, 8, 16)),
             (16, 64, 512, (1, 2, 4, 8, 16)), (100, 16, 256, (1, 2)))
GRU_SWEEP_EDGE = (160, 256, 384, 512)   # hidden of the one-wave edge, B=8
# bf16 flash head_dims outside 64/128/256 up to 256: each padded width
# (64, 128, 192, 256), rows of a multiple of 8 and not
FLASH_HEAD_DIMS = (8, 50, 80, 100, 160, 200, 248, 250)
ITERS = 200
LAYER_CALLS = 7


def digest(x) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch
    raw = x.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def route_times(device, label):
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.kernels.ssd import kernel as sk
    gen = torch.Generator(device=device).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
    for a, t, b, h in ((100, 128, 7, 64), (100, 16, 4, 128)):
        ins = [rnd(a, t, b, 3 * h), rnd(a, h, 3 * h) / h ** 0.5,
               0.1 * rnd(a, 3 * h), rnd(a, b, h),
               (torch.rand(a, t, b, generator=gen, device=device)
                < 0.02).float()]
        hs, g = gk.forward(*ins), rnd(a, t, b, h)
        print(f"{label}: gru_forward {a}x{t}x{b}x{h} output digest "
              f"{digest(hs)}", flush=True)
        for name, fn in (("gru_forward", lambda: gk.forward(*ins)),
                         ("gru_backward", lambda: gk.backward(*ins, hs, g))):
            print(f"{label}: {name} {a}x{t}x{b}x{h}: "
                  f"{chip_smoke.cuda_ms(fn, 20):.4f} ms", flush=True)
    for name, dtype, bh, bhkv, t, window in (
            ("flash_fwd", torch.float32, 16, 8, 2048, 1024),
            ("flash_fwd_sm90", torch.bfloat16, 32, 16, 8192, 4096)):
        q, k, v = (rnd(n, t, 256).to(dtype) for n in (bh, bhkv, bhkv))
        kw = dict(causal=True, sliding_window=window, softcap=50.0)
        ms = chip_smoke.cuda_ms(lambda: fk.forward(q, k, v, **kw), 5)
        print(f"{label}: {name} ({bh}, {t}, 256) window {window}: "
              f"{ms:.4f} ms; output digest "
              f"{digest(fk.forward(q, k, v, **kw))}", flush=True)
        del q, k, v
    bsz, t = chip_smoke.SSM_INPUT
    h, p, n = 48, 64, 128
    for dtype in (torch.float32, torch.bfloat16):
        dt = torch.nn.functional.softplus(rnd(bsz, t, h) - 3.0)
        xw = (rnd(bsz, t, h, p) * dt[..., None]).to(dtype).contiguous()
        la = (dt * -torch.exp(rnd(h) * 0.5)).contiguous()
        bm, c = rnd(bsz, t, n).to(dtype), rnd(bsz, t, n).to(dtype)
        fn = lambda: sk.forward(xw, la, bm, c, chunk=128)
        print(f"{label}: {sk.route(dtype, p, n, 128)} {bsz}x{t}x{h}x{p} N "
              f"{n} L 128: {chip_smoke.cuda_ms(fn, 20):.4f} ms", flush=True)


def flash_case(gen, device, case, dtype):
    """q, k, v of one ``chip_smoke.FLASH_FFMA_CASES`` case in ``dtype``
    (bf16 q scaled by FLASH_Q_SCALE, as the smoke run holds it) and its
    keyword arguments."""
    import torch

    import chip_smoke
    b, h, hkv, t, d, window, cap = case
    rnd = lambda n: torch.randn(b * n, t, d, generator=gen, device=device)
    q, k, v = rnd(h), rnd(hkv), rnd(hkv)
    if dtype == torch.bfloat16:
        q = q * chip_smoke.FLASH_Q_SCALE
    kw = dict(causal=True, sliding_window=window, softcap=cap)
    return (q.to(dtype), k.to(dtype), v.to(dtype)), kw


def wide_times(device, label):
    """The GRU forward at GRU_WIDE_SHAPES and GRU_CELL_SHAPES and bf16
    flash at FLASH_FFMA_CASES, FLASH_ODD_CASE and FLASH_HEAD_DIMS on
    whatever kernel this tree routes them to."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gru import kernel as gk
    gen = torch.Generator(device=device).manual_seed(1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    active = build.extension().gru_forward_cluster_max_active \
        if hasattr(gk, "forward_route") else None
    for a, t, b, h in chip_smoke.GRU_WIDE_SHAPES + GRU_CELL_SHAPES:
        ins = chip_smoke.gru_inputs(gen, a, t, b, h, device)
        ms = chip_smoke.cuda_ms(lambda: gk.forward(*ins), 10 if t > 1
                                else 100)
        kind = (gk.forward_route((a, t, b, h), sms, active)
                if active else gk.route(h))
        print(f"{label}: gru_forward ({kind}) {a}x{t}x{b}x{h}: "
              f"{ms:.4f} ms; output digest {digest(gk.forward(*ins))}",
              flush=True)
        del ins
    first = chip_smoke.FLASH_FFMA_CASES[0]
    for case in chip_smoke.FLASH_FFMA_CASES + (chip_smoke.FLASH_ODD_CASE,) \
            + tuple(first[:4] + (d,) + first[5:] for d in FLASH_HEAD_DIMS):
        (q, k, v), kw = flash_case(gen, device, case, torch.bfloat16)
        d = case[4]
        ms = chip_smoke.cuda_ms(lambda: fk.forward(q, k, v, **kw), 20)
        print(f"{label}: flash bf16 ({fk.route(torch.bfloat16, d)}) "
              f"{case[0]}x{case[1]}/{case[2]}x{case[3]}xD{d} window "
              f"{case[5]} softcap {case[6]}: {ms:.4f} ms", flush=True)
        del q, k, v
    torch.cuda.empty_cache()


def gru_sweep(device):
    """The cluster and the streaming GRU forward on the same inputs at
    GRU_SWEEP and at the one-wave edge of GRU_SWEEP_EDGE."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.gru import kernel as gk
    ext = build.extension()
    active = ext.gru_forward_cluster_max_active
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = [(a, t, b, h) for a, b, h, steps in GRU_SWEEP for t in steps]
    for h in GRU_SWEEP_EDGE:
        most = active(h, *gk.cluster_plan(h, 8, 1, sms))
        cases += [(a, t, 8, h) for a in (most, most + 1) for t in (1, 2)]
    gen = torch.Generator(device=device).manual_seed(0)
    for a, t, b, h in cases:
        ctas, rows = gk.cluster_plan(h, b, a, sms)
        stream_rows = gk.fit_rows(gk.tile_rows(b, a, sms), h,
                                  ext.gru_forward_smem_bytes)
        ins = chip_smoke.gru_inputs(gen, a, t, b, h, device)
        hs = torch.empty(a, t, b, h, device=device)
        iters = 20 if t > 1 else 100
        cluster = chip_smoke.cuda_ms(lambda: ext.gru_forward_cluster(
            *ins, hs, ctas, rows), iters)
        stream = chip_smoke.cuda_ms(lambda: ext.gru_forward(
            *ins, hs, stream_rows), iters)
        print(f"gru sweep {a}x{t}x{b}x{h}: gru_fwd_cluster ({ctas} CTAs x "
              f"{rows} rows, {a * -(-b // rows)} clusters, "
              f"{active(h, ctas, rows)} at once) {cluster:.4f} ms, "
              f"gru_fwd_stream ({stream_rows} rows) {stream:.4f} ms, "
              f"cluster/stream {cluster / stream:.3f}; forward_route "
              f"{gk.forward_route((a, t, b, h), sms, active)}", flush=True)
        del ins, hs


def library_times(device):
    """The PyTorch calls for the wide flash cases' function, timed once:
    SDPA where only the causal mask is set, compiled flex_attention
    where a window or softcap is (null with the reason where it does not
    run)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    gen = torch.Generator(device=device).manual_seed(1)
    for case in chip_smoke.FLASH_FFMA_CASES:
        b, d, window, cap = case[0], case[4], case[5], case[6]
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v), kw = flash_case(gen, device, case, dtype)
            if window is None and cap is None:
                qb, kb, vb = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
                ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, is_causal=True, enable_gqa=True), 10)
                name = "scaled_dot_product_attention (causal, GQA)"
            else:
                ms, name = chip_smoke.flash_library_ms(q, k, v, b, [kw])
            print(f"library {dtype} {case[0]}x{case[1]}/{case[2]}x{case[3]}"
                  f"xD{d} window {window} softcap {cap}: {name}: "
                  + (f"{ms:.4f} ms" if ms is not None else "not measured"),
                  flush=True)
            del q, k, v
            torch.cuda.empty_cache()


def gae_times(device, label):
    import torch

    import chip_smoke
    from repro_torch.kernels.gae import kernel as ak
    gen = torch.Generator(device=device).manual_seed(0)
    for t, b in GAE_SHAPES:
        r, v, nv, g = (torch.randn(t, b, generator=gen, device=device)
                       for _ in range(4))
        d = (torch.rand(t, b, generator=gen, device=device) < 0.05).float()
        calls = {"gae_fwd": lambda: ak.forward(r, v, nv, d, 0.99, 0.95),
                 "gae_bwd": lambda: ak.backward(g, d, 0.99, 0.95)}
        for name, fn in calls.items():
            dev = chip_smoke.device_ms(
                fn, ITERS, "gae_forward" if name == "gae_fwd"
                else "gae_backward", name)
            call = chip_smoke.cuda_ms(fn, ITERS)
            print(f"{label}: {name} ({t}x{b}): device {dev:.5f} ms a "
                  f"launch (torch.profiler, {ITERS} launches); "
                  f"host-inclusive {call:.5f} ms a call (CUDA events, "
                  f"{ITERS} back-to-back calls)", flush=True)


def ssm_layer_time(device, label):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import common
    from repro_torch.nn import ssm
    cfg = common.ssm_layer(chip_smoke.MAMBA2["d_model"],
                           chip_smoke.MAMBA2["state"],
                           head_dim=chip_smoke.MAMBA2["head_dim"]).ssm
    gen = torch.Generator(device=device).manual_seed(2)
    params = ssm.ssm_init(gen, cfg)
    b, t = chip_smoke.SSM_INPUT
    x = torch.randn(b, t, cfg.d_model, generator=gen,
                    device=device).to(cfg.dtype)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ssm.ssm_layer(params, x, cfg, use_kernel=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.inference_mode():
        call()
        warm = statistics.median(call() for _ in range(LAYER_CALLS))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
    ssd_us = sum(ev.time_range.end - ev.time_range.start
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "ssd_chunk" in ev.name)
    print(f"{label}: ssm_layer(use_kernel=True) ({b}, {t}, {cfg.d_model}) "
          f"bf16: warm median of {LAYER_CALLS} {warm * 1e3:.4f} ms; SSD "
          f"kernel device {ssd_us / 1e3:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--library", action="store_true",
                    help="time the PyTorch yardsticks of the wide flash "
                         "cases instead")
    ap.add_argument("--gru-sweep", action="store_true",
                    help="time the cluster GRU forward against the "
                         "streaming one over T instead")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_tree_times: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import dispatch
    device = dispatch.resolve_device("cuda:0")
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    if args.library:
        library_times(device)
        return 0
    if args.gru_sweep:
        gru_sweep(device)
        return 0
    route_times(device, args.label)
    gae_times(device, args.label)
    ssm_layer_time(device, args.label)
    wide_times(device, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
