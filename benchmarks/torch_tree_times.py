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
  calls (host clock) and the SSD kernel's device time in one traced call.

Each tree builds its kernels into the ``build/`` beside its ``src``. Run
the trees in turns in one call, on one card (parent, change, change,
parent), from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_tree_times.py [--src DIR] [--label NAME]
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAE_SHAPES = ((16, 1600), (256, 1600))
ITERS = 200
LAYER_CALLS = 7


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
              f"{ms:.4f} ms", flush=True)
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
    route_times(device, args.label)
    gae_times(device, args.label)
    ssm_layer_time(device, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
