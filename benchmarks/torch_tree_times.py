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
  the GRU backward at GRU_WIDE_SHAPES with the device time of each of
  its kernels (``torch.profiler``), SSD at chunk 256 at mamba2-780m's
  layer width in bf16 and float32, and flash attention in bf16 at
  ``chip_smoke.FLASH_FFMA_CASES`` (head_dim 96, 16, 512),
  ``chip_smoke.FLASH_ODD_CASE`` (36) and, at the first case's shape, at
  the head_dims of FLASH_HEAD_DIMS, and in float32 at the widest case
  (512), each with the route its tree's ``route`` names, so that two
  trees that route these shapes to different kernels time the old
  kernel against the new one;
* a digest of the outputs (the first 16 hex digits of the SHA-256 of
  their bytes) of the GRU forward at 100x128x7x64, of the SSD block at
  chunk 128 and 256, of the wide GRU forward and backward and of every
  flash launch, so that two trees can be compared bit for bit.

With ``--library`` it instead times, once, the PyTorch calls that compute
the wide flash cases' function (yardsticks, never called by the port):
``scaled_dot_product_attention`` at the causal case and compiled
``flex_attention`` (``chip_smoke.flash_library_ms``) at the cases with a
window or softcap, in both dtypes, and in bf16 at
``chip_smoke.FLASH_ODD_CASE`` (36) and ``chip_smoke.FLASH_WIDE_CASES``
(512, 300, 384).

With ``--gru-sweep`` it instead times the GRU forward's two kernels above
hidden 128 on the same inputs, both called past the wrapper's route: the
cluster kernel (``gru_fwd_cluster`` at ``cluster_plan``'s plan) and the
streaming one (``gru_fwd_stream``), over T at one width of each band of
cluster sizes (hidden 160, 256, 384, 512: 5, 8, 12, 16 CTAs) and, at T=1
and 2, on grids of as many clusters as the card holds at once and one
more; beside each, the clusters of the plan the card holds at once and
the route ``forward_route`` takes. That comparison sets
``CLUSTER_MIN_STEPS``. Then the same for the whole backward with its
chain on ``gru_bwd_chain_cluster`` (at the backward's plan) and on
``gru_bwd_chain_stream``, beside ``backward_route``: that sets
``CLUSTER_MIN_STEPS_BWD``.

With ``--gru-phases`` it instead splits the GRU's wide routes at
``chip_smoke.GRU_WIDE_SHAPES``: the backward's device time by kernel
(``torch.profiler``: the gate recompute, the chain on whatever kernel
the tree routes it to, the dW_h partial sums and their sum), and the
cluster forward's time over T (1 to 16 steps at the same A, B, H), a
line fitted through it: the part a launch (the CTAs' W_h load) against
the part a step.

Each tree builds its kernels into the ``build/`` beside its ``src``. Run
the trees in turns in one call, on one card (parent, change, change,
parent), from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_tree_times.py [--src DIR] [--label NAME]
    python3 benchmarks/torch_tree_times.py --library
    python3 benchmarks/torch_tree_times.py --gru-sweep
    python3 benchmarks/torch_tree_times.py --gru-phases [--src DIR]
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
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
# --gru-phases: the steps over which the cluster forward's time is split
# into a part a launch (the W_h load) and a part a step
GRU_PHASE_STEPS = (1, 2, 4, 8, 16)
PHASE_ITERS = 10
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


def digests(xs) -> str:
    """:func:`digest` of each tensor of ``xs``, joined."""
    return "/".join(digest(x) for x in xs)


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
              f"{n} L 128: {chip_smoke.cuda_ms(fn, 20):.4f} ms; output "
              f"digest {digests(fn())}", flush=True)


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
    """The GRU forward at GRU_WIDE_SHAPES and GRU_CELL_SHAPES, the GRU
    backward at GRU_WIDE_SHAPES (with its kernels' device times), SSD at
    chunk 256 at mamba2's width in bf16 and float32, bf16 flash at
    FLASH_FFMA_CASES, FLASH_ODD_CASE and FLASH_HEAD_DIMS and float32 flash
    at the widest of FLASH_FFMA_CASES, each on whatever kernel this tree
    routes it to, with its output's digest."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.kernels.ssd import kernel as sk
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
    for a, t, b, h in chip_smoke.GRU_WIDE_SHAPES:
        ins = chip_smoke.gru_inputs(gen, a, t, b, h, device)
        hs = gk.forward(*ins)
        g = torch.randn(a, t, b, h, generator=gen, device=device)
        call = lambda: gk.backward(*ins, hs, g)
        kind = (gk.backward_route(
            (a, t, b, h), sms, build.extension().
            gru_backward_cluster_max_active)
            if hasattr(gk, "backward_route") else gk.route(h, "backward"))
        ms = chip_smoke.cuda_ms(call, 10)
        split = kernel_device_ms(call, PHASE_ITERS)
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
        print(f"{label}: gru_backward ({kind}) {a}x{t}x{b}x{h}: {ms:.4f} "
              f"ms; device ms by kernel {parts} (sum "
              f"{sum(split.values()):.4f}); output digest "
              f"{digests(call())}", flush=True)
        del ins, hs, g
    bsz, t = chip_smoke.SSM_INPUT
    h, p, n = 48, 64, 128
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, t, h, generator=gen, device=device) - 3.0)
    xw = (torch.randn(bsz, t, h, p, generator=gen, device=device)
          * dt[..., None]).contiguous()
    la = (dt * -torch.exp(torch.randn(h, generator=gen, device=device)
                          * 0.5)).contiguous()
    bm, c = (torch.randn(bsz, t, n, generator=gen, device=device)
             for _ in range(2))
    for dtype in (torch.bfloat16, torch.float32):
        xw32, bm32, c32 = (x.to(dtype) for x in (xw, bm, c))
        fn = lambda: sk.forward(xw32, la, bm32, c32, chunk=256)
        name = str(dtype).replace("torch.", "")
        print(f"{label}: ssd {name} ({sk.route(dtype, p, n, 256)}) "
              f"{bsz}x{t}x{h}x{p} N {n} L 256: "
              f"{chip_smoke.cuda_ms(fn, 10):.4f} ms; output digest "
              f"{digests(fn())}", flush=True)
        del xw32, bm32, c32
    del xw, la, bm, c
    first = chip_smoke.FLASH_FFMA_CASES[0]
    widest = chip_smoke.FLASH_FFMA_CASES[-1]
    for case, dtype in [(c, torch.bfloat16) for c in
                        chip_smoke.FLASH_FFMA_CASES
                        + (chip_smoke.FLASH_ODD_CASE,)
                        + tuple(first[:4] + (d,) + first[5:]
                                for d in FLASH_HEAD_DIMS)] \
            + [(widest, torch.float32)]:
        (q, k, v), kw = flash_case(gen, device, case, dtype)
        d = case[4]
        fn = lambda: fk.forward(q, k, v, **kw)
        print(f"{label}: flash {str(dtype).replace('torch.', '')} "
              f"({fk.route(dtype, d)}) {case[0]}x{case[1]}/{case[2]}x"
              f"{case[3]}xD{d} window {case[5]} softcap {case[6]}: "
              f"{chip_smoke.cuda_ms(fn, 20):.4f} ms; output digest "
              f"{digest(fn())}", flush=True)
        del q, k, v
    torch.cuda.empty_cache()


def gru_sweep(device):
    """The cluster and the streaming GRU forward, then the whole backward
    on the cluster chain and on the streaming one, on the same inputs at
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
    gru_sweep_forward(ext, gk, sms, cases, gen, device)
    bwd_active = ext.gru_backward_cluster_max_active
    cases = [(a, t, b, h) for a, b, h, steps in GRU_SWEEP for t in steps]
    for h in GRU_SWEEP_EDGE:
        most = bwd_active(h, *gk.cluster_plan(h, 8, 1, sms, "backward"))
        cases += [(a, t, 8, h) for a in (most, most + 1) for t in (1, 2)]
    for a, t, b, h in cases:
        ctas, rows = gk.cluster_plan(h, b, a, sms, "backward")
        stream_rows = gk.fit_rows(gk.tile_rows(b, a, sms // 2), h,
                                  ext.gru_backward_smem_bytes)
        ins = chip_smoke.gru_inputs(gen, a, t, b, h, device)
        hs = gk.forward(*ins)
        g = torch.randn(a, t, b, h, generator=gen, device=device)
        new = lambda *shape: torch.empty(shape, device=device)
        scratch = (new(a, t, b, 3 * h), new(a, t, b, h),
                   new(ext.gru_backward_part_floats(a, t, b, h)),
                   new(a, t, b, 3 * h), new(a, h, 3 * h), new(a, 3 * h),
                   new(a, b, h))
        iters = 20 if t > 1 else 100
        cluster = chip_smoke.cuda_ms(lambda: ext.gru_backward(
            *ins, hs, g, *scratch, rows, ctas), iters)
        stream = chip_smoke.cuda_ms(lambda: ext.gru_backward(
            *ins, hs, g, *scratch, stream_rows, 0), iters)
        print(f"gru sweep backward {a}x{t}x{b}x{h}: gru_bwd_chain_cluster "
              f"({ctas} CTAs x {rows} rows, {a * -(-b // rows)} clusters, "
              f"{bwd_active(h, ctas, rows)} at once) {cluster:.4f} ms, "
              f"gru_bwd_chain_stream ({stream_rows} rows) {stream:.4f} ms, "
              f"cluster/stream {cluster / stream:.3f}; backward_route "
              f"{gk.backward_route((a, t, b, h), sms, bwd_active)}",
              flush=True)
        del ins, hs, g, scratch


def gru_sweep_forward(ext, gk, sms, cases, gen, device):
    """The forward half of :func:`gru_sweep`."""
    import torch

    import chip_smoke
    active = ext.gru_forward_cluster_max_active
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


def kernel_device_ms(fn, iters: int) -> dict:
    """Device milliseconds a call of ``fn`` by GRU kernel name (the
    ``gru_*`` function name of each kernel launched), from
    ``torch.profiler`` over ``iters`` calls after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(gru_\w+)", ev.name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + (
                ev.time_range.end - ev.time_range.start) / 1e3 / iters
    return out


def line_fit(xs, ys):
    """(intercept, slope) of the least-squares line through (xs, ys)."""
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / \
        sum((x - mx) ** 2 for x in xs)
    return my - slope * mx, slope


def gru_phases(device):
    """The GRU backward's device time by kernel (the gate recompute, the
    chain on whatever kernel the tree routes it to, the dW_h partial sums
    and their sum) at ``chip_smoke.GRU_WIDE_SHAPES``, and the cluster
    forward's time over T at the same (A, B, H), split by a line fit into
    a part a launch (the CTAs' W_h load, the launch) and a part a step."""
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.gru import kernel as gk
    ext = build.extension()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(0)
    for a, t, b, h in chip_smoke.GRU_WIDE_SHAPES:
        ins = chip_smoke.gru_inputs(gen, a, t, b, h, device)
        hs, g = gk.forward(*ins), torch.randn(a, t, b, h, generator=gen,
                                              device=device)
        whole = chip_smoke.cuda_ms(lambda: gk.backward(*ins, hs, g),
                                   PHASE_ITERS)
        split = kernel_device_ms(lambda: gk.backward(*ins, hs, g),
                                 PHASE_ITERS)
        total = sum(split.values())
        parts = ", ".join(f"{k} {v:.4f} ms ({v / total:.3f})"
                          for k, v in sorted(split.items(),
                                             key=lambda kv: -kv[1]))
        print(f"gru phases backward {a}x{t}x{b}x{h}: {whole:.4f} ms a call "
              f"(CUDA events); device {total:.4f} ms: {parts}", flush=True)
        del ins, hs, g
        ctas, rows = gk.cluster_plan(h, b, a, sms)
        times = []
        for steps in GRU_PHASE_STEPS:
            ins = chip_smoke.gru_inputs(gen, a, steps, b, h, device)
            out = torch.empty(a, steps, b, h, device=device)
            times.append(chip_smoke.cuda_ms(lambda: ext.gru_forward_cluster(
                *ins, out, ctas, rows), PHASE_ITERS))
            del ins, out
        fixed, step = line_fit(GRU_PHASE_STEPS, times)
        clusters = a * -(-b // rows)
        waves = -(-clusters // ext.gru_forward_cluster_max_active(
            h, ctas, rows))
        print(f"gru phases forward cluster {a}xTx{b}x{h} ({ctas} CTAs x "
              f"{rows} rows, {clusters} clusters in {waves} waves): "
              + ", ".join(f"T={s} {v:.4f} ms"
                          for s, v in zip(GRU_PHASE_STEPS, times))
              + f"; fit {fixed:.4f} ms a launch + {step:.4f} ms a step "
              f"({fixed / waves * 1e3:.2f} + {step / waves * 1e3:.2f} us a "
              f"wave; at T={t}: {fixed / (fixed + step * t):.3f} of it a "
              f"launch)", flush=True)
        torch.cuda.empty_cache()


def library_times(device):
    """The PyTorch calls for the wide flash cases' function and, in
    bf16, FLASH_ODD_CASE's and FLASH_WIDE_CASES', timed once: SDPA where
    only the causal mask is set,
    compiled flex_attention where a window or softcap is (null with the
    reason where it does not run)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    gen = torch.Generator(device=device).manual_seed(1)
    bf16_only = (chip_smoke.FLASH_ODD_CASE,) + tuple(
        c for c in chip_smoke.FLASH_WIDE_CASES
        if c not in chip_smoke.FLASH_FFMA_CASES)
    for case, dtypes in [(c, (torch.bfloat16, torch.float32))
                         for c in chip_smoke.FLASH_FFMA_CASES] + [
            (c, (torch.bfloat16,)) for c in bf16_only]:
        b, d, window, cap = case[0], case[4], case[5], case[6]
        for dtype in dtypes:
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
    ap.add_argument("--gru-phases", action="store_true",
                    help="split the GRU backward by kernel and the cluster "
                         "forward into its W_h load and its steps instead")
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
    if args.gru_phases:
        gru_phases(device)
        return 0
    route_times(device, args.label)
    gae_times(device, args.label)
    ssm_layer_time(device, args.label)
    wide_times(device, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
