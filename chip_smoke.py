#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
     csrc``, prints the build seconds, and reads the built library with
     ``cuobjdump``: registers, stack, local memory and HGMMA (tensor-core)
     instructions of each flash kernel (the bf16 one must have HGMMA), and
     registers, stack and local memory of each GRU kernel (those that keep
     W_h in registers must not spill), and the same with HGMMA for each
     instantiation of the bf16 SSD kernel ``ssd_chunk_sm90`` (each must
     have HGMMA);
  3. holds every kernel against its plain torch version on the card at
     the shapes its path gives it and times kernel, plain version and,
     where one exists, the one PyTorch call for the same function, with
     CUDA events: GRU (1e-5 times max(1, largest magnitude)) forward and
     backward at each of the forward's three FNN-policy path shapes, at
     the recurrent policy's (100x16x4, 100x1x16 and 100x1x8 at hidden
     128) and at 1x16x64 and 1x128x256 at hidden 128, the backward twice
     for its bits,
     times per launch and per step at each; GAE forward (bit for bit) and
     backward (1e-6), each with its device time per launch
     (``torch.profiler``) beside its host-inclusive time per call; flash
     attention at gemma2-9b's prefill
     shapes on bf16 inputs (the tensor-core kernel), against the plain
     version in float32 on the same inputs (1e-3 + 8e-3 |plain|), with its
     achieved TFLOP/s and share of the bf16 bound beside compiled
     ``flex_attention``, and one float32 shape (2e-5, the FFMA kernel); the
     SSD intra-chunk block and the SSD op at mamba2-780m's layer width, in
     float32 (2e-4, the FFMA kernel ``ssd_chunk``) and bf16 (the
     tensor-core kernel ``ssd_chunk_sm90`` and, as its "before",
     ``ssd_chunk`` on the same inputs), both bf16 routes timed, and at
     zamba2-1.2b's width (64 heads, state 64);
  4. drives the DIALS paths at side=10 (100 agents) at the library's
     default widths with the GRU AIP, ``use_kernels="on"``, checking every
     round record and printing each round's phase seconds: warehouse with
     the FNN policy (one round); warehouse with the paper's recurrent
     policy (gru_hidden 128; two rounds, the GRU kernels launched at
     hidden 128 in the rollout cell and ppo_loss); traffic with the FNN
     policy (one round), then the GS-trained baseline (``make_gs_trainer``,
     5 timed ``train_fn`` steps and one ``eval_fn``, launching the GAE
     kernel); powergrid and supplychain, a 32-step GS trajectory each on
     the card and on the CPU, bit for bit, and one narrow-width round each;
     the recurrent-policy path again through a checkpoint: stopped after
     round 0, resumed by a new trainer for round 1, its record and state
     against the uninterrupted run (max abs differences printed); then
     the kernel path against the plain path on a small input (one round,
     warehouse side=2);
  5. drives the serving path of gemma2-9b at full width (bf16, random
     weights from a seed): the prefill step over a B=2 x T=8192 prompt
     with the flash kernel (42 launches, all of the bf16 kernel) and
     without it, their last
     logits compared, then a greedy decode of 16 tokens at B=4 after a
     32-token prompt; then profiles one prefill and 8 decode steps
     (device busy share, device time by kernel, flash's share);
  6. drives ``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
     (2, 8192, 1536) bf16 activations (one launch of ``ssd_chunk_sm90``)
     against ``use_kernel=False``, then times both warm (median of 7) and
     profiles the kernel call (the SSD kernel's share of its device time);
  7. prints the kernel table as one JSON line, the nvidia-smi line, and
     as its last line ``{"ok": true, "device": {...}}``.

Each path (each of 4's, 5, 6) runs with every launch count set to 0 just
before it and read just after (the kernels line gives each kernel's
launches by path); each phase prints its seconds. Any failed phase
exits non-zero without the last line. Without CUDA, or without the
repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, fp32
# outside the tensor cores (the GRU/GAE kernels' inputs) and dense bf16 on
# the tensor cores (the bound for the LM kernels' bf16 inputs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
GRU_TOL = 1e-5
GAE_TOL = 1e-6
# flash: |err| <= atol + rtol*|plain|. float32: the reference's 2e-5. bf16
# inputs: the plain version runs in float32 on the same inputs, so only the
# kernel's bf16 output rounding (at most 2^-8 relative) and the order of
# float32 sums differ. q is scaled by 8 there, so the scores (std 8, row
# maxima near 30) reach the softcap of 50 and a few keys lead each row's
# softmax: a mask, tile or softcap fault moves outputs by order |v| = 1.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
FLASH_Q_SCALE = 8.0
# SSD: float32 the reference's 2e-4; bf16 outputs stored in bf16 within
# 1e-2 times max(1, largest magnitude) (two bf16 roundings of 2^-8 each)
SSD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# gemma2-9b last logits, flash against plain prefill, and the SSM layer's
# output, kernel against plain, both bf16: within tol times max(1, largest
# magnitude) (bf16 rounding flips at other places, carried through the
# stack)
LOGIT_TOL = 5e-2
SSM_LAYER_TOL = 2e-2

# The DIALS paths: side=10 (100 agents), the library's default widths,
# DIALSConfig() cut to a few rounds and F=5. The first slice's path
# (warehouse, FNN policy) runs one round; the recurrent policy's path two,
# the second of which the checkpoint resume repeats; traffic one round and
# the GS baseline GS_TRAIN_STEPS steps; powergrid and supplychain an
# ENV_STEPS-step GS trajectory each, card against CPU.
SIDE = 10
AIP_REFRESH = 5
FNN_ROUNDS = 1
GRU_POLICY_ROUNDS = 2
GS_TRAIN_STEPS = 5
ENV_STEPS = 32

# The serving slice: gemma2-9b at full width (src/repro/configs/gemma2_9b.py),
# prompt B=2 x T=8192 (prefill_32k cut from B=32 x 32768), greedy decode of
# 16 tokens at B=4 after a 32-token prompt (examples/serve_decode.py).
GEMMA_PROMPT = (2, 8192)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 32, 16
PROFILE_DECODE_STEPS = 8
# mamba2-780m's SSM layer (src/repro/configs/mamba2_780m.py:15-17) on
# (2, 8192, 1536) activations
MAMBA2 = dict(d_model=1536, state=128, head_dim=64)
# zamba2-1.2b's SSM layer (src/repro/configs/zamba2_1_2b.py:28): d_model
# 2048, expand 2, heads of 64, state 64
ZAMBA2 = dict(heads=64, state=64)
SSM_INPUT = (2, 8192)
SSM_TIMED = 7


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters``
    calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, match: str):
    """Device milliseconds per launch of the kernels whose name contains
    ``match``, from ``torch.profiler``: the mean of the last ``iters`` of
    ``iters + 2`` traced calls of ``fn`` after one untraced warm-up call
    (the tracer may miss a launch at its start): the kernel's own time,
    without the host's cost of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 2):
            fn()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and match in ev.name)
    check(len(spans) >= iters, f"profiler saw {len(spans)} launches of "
                               f"{match} in {iters + 2} calls")
    return sum(end - start for start, end in spans[-iters:]) / 1e3 / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_FP32_PER_S):
    """The least time of the card for this work, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launched(table, key: str, fn):
    """``fn()``, checking that it launched the ``key`` kernel once by its
    wrapper's count in ``table``."""
    before = table[key]
    out = fn()
    check(table[key] == before + 1, f"the {key} kernel was not launched")
    return out


def max_err(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max())


def allclose_err(pairs, tol: float) -> float:
    """Max abs error over (name, kernel, plain) triples; raises unless
    every kernel output is finite and within tol * max(1, max |plain|)
    of the plain version (absolute at magnitudes <= 1, relative to the
    largest magnitude above: the gradients sum T*B terms)."""
    import torch
    worst = 0.0
    for name, k, p in pairs:
        err = max_err(k, p)
        scale = max(1.0, float(p.detach().abs().max()))
        check(bool(torch.isfinite(k).all()) and err <= tol * scale,
              f"{name}: kernel disagrees with plain version "
              f"(max abs err {err:.3e}, allowed {tol} * {scale:.4g})")
        worst = max(worst, err)
    return worst


def allclose_rel(name, k, p, atol: float, rtol: float) -> float:
    """Max abs error; raises unless the kernel output is finite and
    |k - p| <= atol + rtol*|p| everywhere (numpy's allclose rule)."""
    import torch
    k64, p64 = k.double(), p.double()
    diff = (k64 - p64).abs()
    ok = bool(torch.isfinite(k64).all()) and \
        not bool((diff > atol + rtol * p64.abs()).any())
    err = float(diff.max())
    check(ok, f"{name}: kernel disagrees with plain version (max abs err "
              f"{err:.3e}, atol {atol}, rtol {rtol})")
    return err


# ---------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------
def gru_inputs(gen, a, t, b, hdim, device):
    import torch
    rnd = lambda *s, scale=1.0: scale * torch.randn(
        *s, generator=gen, device=device)
    gi = rnd(a, t, b, 3 * hdim)
    wh = rnd(a, hdim, 3 * hdim, scale=hdim ** -0.5)
    bh = rnd(a, 3 * hdim, scale=0.1)
    h0 = rnd(a, b, hdim, scale=0.5)
    resets = (torch.rand(a, t, b, generator=gen, device=device)
              < 0.02).float()
    return gi, wh, bh, h0, resets


def gru_case(gen, device, a, t, b, hdim):
    """Inputs, output cotangent, and the kernels' and plain version's
    forward and gradients at one shape; returns (worst forward error,
    worst gradient error, inputs, cotangent)."""
    import torch
    from repro_torch.kernels.gru import kernel as gk, ref as gref
    name = f"{a}x{t}x{b}x{hdim}"
    gi, wh, bh, h0, resets = gru_inputs(gen, a, t, b, hdim, device)
    g = torch.randn(a, t, b, hdim, generator=gen, device=device)
    leaves = [x.clone().requires_grad_() for x in (gi, wh, bh, h0)]
    hs_k = gk.GRUScan.apply(*leaves, resets)
    grads_k = torch.autograd.grad(hs_k, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (gi, wh, bh, h0)]
    hs_p = gref.gru_scan(*ref_leaves, resets)
    grads_p = torch.autograd.grad(hs_p, ref_leaves, g)
    fwd = allclose_err([(f"gru_forward {name}", hs_k, hs_p)], GRU_TOL)
    bwd = allclose_err(
        [(f"gru_backward {name} d{n}", k, p) for n, k, p in
         zip(("gi", "wh", "bh", "h0"), grads_k, grads_p)], GRU_TOL)
    again = gk.backward(gi, wh, bh, h0, resets, hs_k.detach(), g)
    check(all(torch.equal(x, y) for x, y in zip(
        again, gk.backward(gi, wh, bh, h0, resets, hs_k.detach(), g))),
        f"gru_backward {name}: two calls differ in their bits")
    print(f"gru {name}: forward max abs err {fwd:.3e}, backward {bwd:.3e} "
          f"(tol {GRU_TOL} * max(1, max |plain|)); backward bitwise "
          f"repeatable", flush=True)
    return fwd, bwd, (gi, wh, bh, h0, resets), g


def gru_bounds(a, t, b, hdim):
    """(forward, backward) bounds: each input read once, each output
    written once; the forward's h.W_h and gates, the backward's gate
    recompute, h.W_h^T, hp^T.dgh and gate adjoints."""
    n = a * t * b
    fwd = bound_ms(4.0 * (n * 3 * hdim + a * hdim * 3 * hdim + a * 3 * hdim
                          + a * b * hdim + n + n * hdim),
                   n * (6.0 * hdim * hdim + 20.0 * hdim))
    bwd = bound_ms(4.0 * (2 * (n * 3 * hdim + a * hdim * 3 * hdim
                               + a * 3 * hdim + a * b * hdim) + n
                          + 2 * n * hdim),
                   n * (18.0 * hdim * hdim + 40.0 * hdim))
    return fwd, bwd


def check_gru(gen, device, shapes):
    """Both kernels against the plain version at every main-path shape
    and at H=128 (the recurrent policy's width), the backward twice for
    its bits; times per launch and per step at each shape. Returns the
    two kernel rows, timed at the AIP training shape."""
    import torch
    from repro_torch.kernels.gru import kernel as gk, ref as gref
    fwd_err = bwd_err = 0.0
    timed = {}
    for a, t, b, hdim in shapes["gru_forward"] + shapes["gru_h128"]:
        fe, be, ins, g = gru_case(gen, device, a, t, b, hdim)
        fwd_err, bwd_err = max(fwd_err, fe), max(bwd_err, be)
        hs = gk.forward(*ins)
        iters = 20 if t > 1 else 200
        f_ms = cuda_ms(lambda: gk.forward(*ins), iters)
        b_ms = cuda_ms(lambda: gk.backward(*ins, hs, g), iters)
        fb, bb = gru_bounds(a, t, b, hdim)
        timed[(a, t, b, hdim)] = (f_ms, b_ms, ins, g, hs, fb[0], bb[0])
        print(f"gru {a}x{t}x{b}x{hdim}: forward {f_ms:.4f} ms a launch, "
              f"{f_ms * 1e3 / t:.3f} us a step (bound {fb[0]:.5f} ms); "
              f"backward {b_ms:.4f} ms, {b_ms * 1e3 / t:.3f} us a step "
              f"(bound {bb[0]:.5f} ms)", flush=True)
        del hs
        torch.cuda.empty_cache()

    key = shapes["gru_backward"]
    f_ms, b_ms, ins, g, hs = timed[key][:5]
    ref_leaves = [x.clone().requires_grad_() for x in ins[:4]]
    hs_p = gref.gru_scan(*ref_leaves, ins[4])
    fb, bb = gru_bounds(*key)
    by_shape = lambda d: {"x".join(map(str, k)): v for k, v in d.items()}
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/gru.cu",
                  shape="x".join(map(str, key)),
                  ms_by_shape=by_shape({k: v[0] for k, v in timed.items()}),
                  bound_ms_by_shape=by_shape({k: v[5]
                                              for k, v in timed.items()}))
    return [
        dict(name="gru_forward",
             replaces="src/repro/kernels/gru/kernel.py:64",
             max_abs_err=fwd_err, ms=f_ms,
             plain_ms=cuda_ms(lambda: gref.gru_scan(*ins), 10), bound=fb,
             **common),
        dict(name="gru_backward",
             replaces="src/repro/kernels/gru/kernel.py:132",
             max_abs_err=bwd_err, ms=b_ms,
             plain_ms=cuda_ms(lambda: torch.autograd.grad(
                 hs_p, ref_leaves, g, retain_graph=True), 10), bound=bb,
             **dict(common, ms_by_shape=by_shape(
                 {k: v[1] for k, v in timed.items()}),
                 bound_ms_by_shape=by_shape(
                     {k: v[6] for k, v in timed.items()}))),
    ]


def check_gae(gen, device, t, b, gamma, lam):
    import torch
    from repro_torch.kernels.gae import kernel as ak, ref as aref
    r, v, nv = (torch.randn(t, b, generator=gen, device=device)
                for _ in range(3))
    d = (torch.rand(t, b, generator=gen, device=device) < 0.05).float()
    g = torch.randn(t, b, generator=gen, device=device)
    kw = dict(gamma=gamma, lam=lam)
    adv_k = ak.forward(r, v, nv, d, gamma, lam)
    adv_p = aref.gae_reverse_scan(r, v, nv, d, **kw)
    check(torch.equal(adv_k, adv_p), "gae_forward: not bit for bit equal to "
                                     "the plain version")
    fwd_err = max_err(adv_k, adv_p)
    leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    grads_k = torch.autograd.grad(
        ak.GAEScan.apply(*leaves, d, gamma, lam), leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    adv_p = aref.gae_reverse_scan(*ref_leaves, d, **kw)
    grads_p = torch.autograd.grad(adv_p, ref_leaves, g, retain_graph=True)
    bwd_err = allclose_err(
        [(f"d{n}", k, p) for n, k, p in
         zip(("rewards", "values", "next_values"), grads_k, grads_p)],
        GAE_TOL)
    iters = 200
    n = t * b
    fwd = lambda: ak.forward(r, v, nv, d, gamma, lam)
    bwd = lambda: ak.backward(g, d, gamma, lam)
    rows = [
        dict(name="gae_forward", route="cuda",
             source="src/repro_torch/kernels/csrc/gae.cu",
             replaces="src/repro/kernels/gae/kernel.py:45",
             max_abs_err=fwd_err, ms=device_ms(fwd, iters, "gae_fwd"),
             call_ms=cuda_ms(fwd, iters),
             plain_ms=cuda_ms(
                 lambda: aref.gae_reverse_scan(r, v, nv, d, **kw), iters),
             bound=bound_ms(4.0 * 5 * n, 8.0 * n)),
        dict(name="gae_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/gae.cu",
             replaces="src/repro/kernels/gae/kernel.py:80",
             max_abs_err=bwd_err, ms=device_ms(bwd, iters, "gae_bwd"),
             call_ms=cuda_ms(bwd, iters),
             plain_ms=cuda_ms(lambda: torch.autograd.grad(
                 adv_p, ref_leaves, g, retain_graph=True), iters),
             bound=bound_ms(4.0 * 4 * n, 6.0 * n)),
    ]
    for row in rows:
        print(f"{row['name']} ({t}x{b}): device time {row['ms']:.5f} ms a "
              f"launch (torch.profiler, {iters} launches); host-inclusive "
              f"{row['call_ms']:.5f} ms a call (CUDA events over {iters} "
              f"back-to-back wrapper calls); bound {row['bound'][0]:.6f} ms",
              flush=True)
    return rows


# ---------------------------------------------------------------------------
# the LM kernels against their plain versions, at the serving paths' shapes
# ---------------------------------------------------------------------------
def live_pairs(t: int, window) -> int:
    """(query, key) pairs a causal mask with this window leaves live, for
    one (batch, head) row: what this run's data needs."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def check_flash(gen, device):
    """gemma2-9b prefill attention (B=2, T=8192, 16 heads over 8 KV heads,
    head_dim 256, softcap 50), bf16, local (window 4096) and global
    layers, on the tensor-core kernel; one float32 shape on the FFMA
    kernel. Returns the kernel row: times are per launch, averaged over one
    local and one global launch, as the prefill alternates them."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.configs import registry
    attn = registry.get("gemma2-9b").cfg.period[0].attn
    b, t = GEMMA_PROMPT
    h, hkv, d = attn.num_heads, attn.num_kv_heads, attn.dh
    window, cap = attn.sliding_window, attn.attn_softcap
    worst = 0.0

    def inputs(bb, tt, dtype):
        rnd = lambda n: torch.randn(bb * n, tt, d, generator=gen,
                                    device=device).to(dtype)
        return rnd(h), rnd(hkv), rnd(hkv)

    # float32 at the reference's 2e-5 on the FFMA kernel (a shorter prompt:
    # the plain version materialises the (T, T) scores in float32)
    q, k, v = inputs(1, 2048, torch.float32)
    kw = dict(causal=True, sliding_window=1024, softcap=cap)
    worst = max(worst, allclose_rel(
        "flash float32 T=2048",
        launched(fk.LAUNCHES, "flash_fwd",
                 lambda: fk.forward(q, k, v, **kw)),
        fr.attention_bhsd(q, k, v, **kw), *FLASH_TOL["float32"]))
    ffma_ms = cuda_ms(lambda: fk.forward(q, k, v, **kw), 5)
    ffma_plain_ms = cuda_ms(lambda: fr.attention_bhsd(q, k, v, **kw), 3)
    print(f"flash float32 (FFMA kernel flash_fwd) q {tuple(q.shape)}, k/v "
          f"{tuple(k.shape)}, window 1024, softcap {cap}: {ffma_ms:.4f} ms "
          f"a launch (plain {ffma_plain_ms:.4f} ms)", flush=True)
    del q, k, v

    # bf16 at the main path's shapes, q scaled by FLASH_Q_SCALE, held to the
    # plain version in float32 on the same (upcast) bf16 inputs, one batch
    # row at a time to bound the (T, T) float32 scores
    q, k, v = inputs(b, t, torch.bfloat16)
    q = q * FLASH_Q_SCALE
    cases = [dict(causal=True, sliding_window=w, softcap=cap)
             for w in (window, None)]
    for kw in cases:
        got = launched(fk.LAUNCHES, "flash_fwd_sm90",
                       lambda: fk.forward(q, k, v, **kw))
        want = torch.cat([fr.attention_bhsd(
            q[i * h:(i + 1) * h].float(), k[i * hkv:(i + 1) * hkv].float(),
            v[i * hkv:(i + 1) * hkv].float(), **kw) for i in range(b)])
        name = f"flash bf16 window={kw['sliding_window']}"
        worst = max(worst, allclose_rel(name, got, want,
                                        *FLASH_TOL["bfloat16"]))
        diff = (got.double() - want.double()).norm()
        print(f"{name}: mean |o| {float(want.abs().mean()):.4f}, max |o| "
              f"{float(want.abs().max()):.4f}, |err| / |o| (norms) "
              f"{float(diff / want.double().norm()):.3e}", flush=True)
        del got, want
        torch.cuda.empty_cache()

    pair = lambda fn: (lambda: [fn(**kw) for kw in cases])
    ms = cuda_ms(pair(lambda **kw: fk.forward(q, k, v, **kw)), 5) / 2
    plain_ms = cuda_ms(pair(lambda **kw: fr.attention_bhsd(q, k, v, **kw)),
                       1) / 2
    torch.cuda.empty_cache()
    lib_ms, lib_name = flash_library_ms(q, k, v, b, cases)
    pairs = b * h * sum(live_pairs(t, kw["sliding_window"]) for kw in cases)
    flop = 4.0 * d * pairs / len(cases)           # a launch, mean of both
    nbytes = 2.0 * (2 * b * h * t * d + 2 * b * hkv * t * d)
    bound = bound_ms(nbytes, flop, PEAK_BF16_PER_S)
    print(f"flash bf16 (tensor-core kernel flash_fwd_sm90): {flop / 1e12:.4f}"
          f" TFLOP a launch; {ms:.4f} ms, {flop / ms / 1e9:.2f} TFLOP/s, "
          f"{bound[0] / ms:.4f} of the bf16 bound ({bound[0]:.4f} ms by "
          f"{bound[1]}); {lib_name}: "
          + (f"{lib_ms:.4f} ms, {flop / lib_ms / 1e9:.2f} TFLOP/s"
             if lib_ms is not None else "not measured"), flush=True)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:95",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=bound,
                library_ms=lib_ms, library=lib_name if lib_ms is not None
                else None)


def flash_library_ms(q, k, v, b, cases):
    """One PyTorch call for the same function, timed as a yardstick only:
    ``flex_attention`` (compiled) with a softcap ``score_mod`` and a
    causal+window ``mask_mod``. Returns (ms a launch, its name), or (None,
    the reason) if it does not run here: no other call computes this
    function (SDPA has no softcap), so none stands in for it."""
    import torch
    qb, kb, vb = (x.view(b, -1, x.shape[1], x.shape[2]) for x in (q, k, v))
    name = "flex_attention (compiled, softcap score_mod, causal+window mask)"
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        flex = torch.compile(flex_attention)
        cap = cases[0]["softcap"]

        def score_mod(s, bi, hi, qi, ki):
            return cap * torch.tanh(s / cap)

        calls = []
        for kw in cases:
            win = kw["sliding_window"]

            def mask_mod(bi, hi, qi, ki, win=win):
                live = ki <= qi
                return live if win is None else live & (ki > qi - win)

            mask = create_block_mask(mask_mod, None, None, q.shape[1],
                                     k.shape[1], device=q.device)
            calls.append(lambda m=mask: flex(
                qb, kb, vb, score_mod=score_mod, block_mask=m,
                enable_gqa=True))
        return cuda_ms(lambda: [c() for c in calls], 3) / 2, name
    except Exception as exc:     # a yardstick: the port never calls it
        reason = (f"{name} did not run ({type(exc).__name__}: "
                  f"{str(exc)[:200]}); library_ms is null")
        print(reason, flush=True)
        return None, reason


def kernel_resources():
    """Registers, stack and local memory (``cuobjdump -res-usage``) of
    each flash and GRU kernel in the built library, dynamic shared memory,
    and HGMMA instructions (``cuobjdump -sass``) of each flash kernel.
    Fails unless every instantiation of the bf16 flash kernel issues HGMMA,
    and if a GRU kernel that keeps W_h in registers spills to local
    memory (a stack frame or local bytes)."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(build.LIBRARY)
    run = lambda *a: subprocess.run([tool, *a, lib], capture_output=True,
                                    text=True, timeout=300,
                                    check=True).stdout
    res_usage = run("-res-usage")
    flash = re.compile(r"(flash_fwd(?:_sm90)?)ILi(\d+)E")
    usage, fn = {}, None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = flash.search(m.group(1))
        elif fn and "REG:" in line:
            name, n = fn.group(1), int(fn.group(2))
            d = n if name.endswith("sm90") else 64 * n
            usage[(name, d)] = dict(re.findall(r"(\w+):(\d+)", line))
            fn = None
    sass = run("-sass")
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = flash.search(m.group(1))
        elif fn and "HGMMA" in line:
            name, n = fn.group(1), int(fn.group(2))
            d = n if name.endswith("sm90") else 64 * n
            hgmma[(name, d)] = hgmma.get((name, d), 0) + 1
    ext = build.extension()
    for (name, d), use in sorted(usage.items()):
        smem = ext.flash_attention_sm90_smem_bytes(d) \
            if name == "flash_fwd_sm90" else None
        print(f"resources {name} D={d}: REG {use.get('REG')} (at entry), "
              f"STACK {use.get('STACK')}, LOCAL {use.get('LOCAL')}, static "
              f"SHARED {use.get('SHARED')}, dynamic shared "
              f"{smem if smem is not None else 'see flash_attention.cu'}, "
              f"HGMMA {hgmma.get((name, d), 0)}", flush=True)
    for d in (64, 128, 256):
        check(("flash_fwd_sm90", d) in usage,
              f"flash_fwd_sm90 D={d} not found in {lib}")
        check(hgmma.get(("flash_fwd_sm90", d), 0) > 0,
              f"flash_fwd_sm90 D={d} issues no HGMMA: not on the tensor "
              f"cores")
    ssd_resources(res_usage, sass, ext)
    gru_resources(res_usage, ext)


def ssd_resources(res_usage: str, sass: str, ext):
    """Registers, stack, local memory, dynamic shared memory and HGMMA
    count of each instantiation (chunk L, state N) of ``ssd_chunk_sm90``;
    fails unless all four are built and every one issues HGMMA."""
    import re
    pat = re.compile(r"ssd_chunk_sm90ILi(\d+)ELi(\d+)E")
    usage, hgmma, fn = {}, {}, None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = pat.search(m.group(1))
        elif fn and "REG:" in line:
            usage[fn.groups()] = dict(re.findall(r"(\w+):(\d+)", line))
            fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = pat.search(m.group(1))
        elif fn and "HGMMA" in line:
            hgmma[fn.groups()] = hgmma.get(fn.groups(), 0) + 1
    for (lc, nc), use in sorted(usage.items()):
        print(f"resources ssd_chunk_sm90 L={lc} N={nc}: REG {use.get('REG')}"
              f" (at entry), STACK {use.get('STACK')}, LOCAL "
              f"{use.get('LOCAL')}, dynamic shared "
              f"{ext.ssd_sm90_smem_bytes(int(lc), 64, int(nc))}, HGMMA "
              f"{hgmma.get((lc, nc), 0)}", flush=True)
    for lc in ("64", "128"):
        for nc in ("64", "128"):
            check((lc, nc) in usage,
                  f"ssd_chunk_sm90 L={lc} N={nc} not in the library")
            check(hgmma.get((lc, nc), 0) > 0,
                  f"ssd_chunk_sm90 L={lc} N={nc} issues no HGMMA")


def gru_resources(res_usage: str, ext):
    """The GRU kernels' lines of ``cuobjdump -res-usage``: the recurrent
    kernels by configuration (units a thread, lanes a unit, elements a
    lane, rows a tile, W_h in registers or not) with their dynamic shared
    memory at the widest hidden size each serves (64 in registers, 128 in
    shared memory), and the backward's GEMM kernels."""
    import re
    recur = re.compile(r"(gru_fwd|gru_bwd_chain)ILi(\d+)ELi(\d+)ELi(\d+)"
                       r"ELi(\d+)ELb([01])E")
    plain = re.compile(r"(gru_bwd_weights_sum|gru_bwd_weights|"
                       r"gru_bwd_gates)E")
    found, fn = [], None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = recur.search(m.group(1)) or plain.search(m.group(1))
        elif fn and "REG:" in line:
            found.append((fn.groups(), dict(re.findall(r"(\w+):(\d+)",
                                                       line))))
            fn = None
    check(any(g[0] == "gru_fwd" and g[5] == "1" for g, _ in found) and
          any(g[0] == "gru_bwd_chain" and g[5] == "1" for g, _ in found),
          "the GRU kernels with W_h in registers are not in the library")
    for groups, use in sorted(found):
        name = groups[0]
        if len(groups) == 1:
            print(f"resources {name}: REG {use.get('REG')}, STACK "
                  f"{use.get('STACK')}, LOCAL {use.get('LOCAL')}",
                  flush=True)
            continue
        upt, ks, kpt, rows, wreg = (int(x) for x in groups[1:])
        hdim = 64 if wreg else 128
        smem = (ext.gru_forward_smem_bytes if name == "gru_fwd"
                else ext.gru_backward_smem_bytes)(hdim, rows)
        print(f"resources {name} units/thread {upt} lanes/unit {ks} "
              f"elements/lane {kpt} rows {rows} W_h in "
              f"{'registers' if wreg else 'shared memory'}: REG "
              f"{use.get('REG')}, STACK {use.get('STACK')}, LOCAL "
              f"{use.get('LOCAL')}, dynamic shared {smem} bytes at H="
              f"{hdim}", flush=True)
        if wreg:
            check(use.get("STACK") == "0" and use.get("LOCAL") == "0",
                  f"{name} (rows {rows}) keeps W_h in registers but spills "
                  f"to local memory: STACK {use.get('STACK')}, LOCAL "
                  f"{use.get('LOCAL')}")


def ssd_ffma(xw, la, bm, c, chunk):
    """``ssd.cu`` on the given inputs whatever their dtype and shape, past
    the wrapper's route: the bf16 "before" of ``ssd_chunk_sm90``, for the
    comparison only (it counts no launch)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel as sk
    bsz, t, h, p = xw.shape
    n, nc = bm.shape[-1], t // chunk
    sms = torch.cuda.get_device_properties(xw.device).multi_processor_count
    y = torch.empty_like(xw)
    st = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                     device=xw.device)
    cd = torch.empty((bsz, nc, h), dtype=torch.float32, device=xw.device)
    build.extension().ssd_intra_chunk(xw, la, bm, c, y, st, cd, chunk,
                                      sk.heads_per_block(bsz, nc, h, sms))
    return y, st, cd


def ssd_bound(bsz, t, h, p, n, chunk):
    """Each input read once and each output written once (bf16 x, b, c and
    y, f32 la, states and decay); C·Bᵀ once per (b, chunk) and per head
    the causal half of M·X, the decay-weighted M and the chunk state, on
    the bf16 tensor cores."""
    nc = t // chunk
    nbytes = (2.0 * (2 * bsz * t * h * p + 2 * bsz * t * n)
              + 4.0 * (bsz * t * h + bsz * nc * h * p * n + bsz * nc * h))
    ops = bsz * nc * (2.0 * chunk * chunk * n + h * (
        p * chunk * (chunk + 1) + 2.0 * chunk * chunk
        + 2.0 * chunk * p * n + chunk * n))
    return bound_ms(nbytes, ops, PEAK_BF16_PER_S)


def check_ssd(gen, device):
    """The SSD intra-chunk block at mamba2-780m's layer width (B=2,
    T=8192, 48 heads of 64, state 128, chunk 128): in float32 on the FFMA
    kernel ``ssd_chunk`` (2e-4), in bf16 on the tensor-core kernel
    ``ssd_chunk_sm90`` and, as its "before", on ``ssd_chunk`` (y 1e-2,
    states and decay 2e-4, scaled), each output against the plain
    intra-chunk block in float32 on the same inputs; ``ops.ssd`` against
    ``ssd_chunked`` in both dtypes. Times both bf16 routes and the plain
    version there, and both routes at zamba2-1.2b's width (64 heads, state
    64). Returns the kernel row (bf16, the layer's dtype)."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk, ops as so, ref as sr
    from repro_torch.configs import common
    from repro_torch.nn import ssm
    cfg = common.ssm_layer(MAMBA2["d_model"], MAMBA2["state"],
                           head_dim=MAMBA2["head_dim"]).ssm
    bsz, t = SSM_INPUT
    h, p, n, chunk = cfg.num_heads, cfg.head_dim, cfg.state, cfg.chunk
    worst = 0.0

    def inputs(h, n, dtype):
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
        x = rnd(bsz, t, h, p).to(dtype)
        dt = torch.nn.functional.softplus(rnd(bsz, t, h) - 3.0)
        a = -torch.exp(rnd(h) * 0.5)
        bm, c = rnd(bsz, t, n).to(dtype), rnd(bsz, t, n).to(dtype)
        xw = (x * dt[..., None].to(dtype)).contiguous()
        return x, dt, a, bm, c, xw, (dt * a).contiguous()

    def held(label, got, want, name):
        tols = (SSD_TOL[name], SSD_TOL["float32"], SSD_TOL["float32"])
        err = 0.0
        for what, g, w, tol in zip(("y", "states", "chunk_decay"), got,
                                   want, tols):
            e = allclose_err([(f"{label} {what}", g, w)], tol)
            print(f"{label} {what}: max abs err {e:.3e}, max |plain| "
                  f"{float(w.abs().max()):.4f}, allowed {tol} * max(1, "
                  f"max |plain|)", flush=True)
            err = max(err, e)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, c, xw, la = inputs(h, n, dtype)
        name = str(dtype).replace("torch.", "")
        key = sk.route(dtype, p, n, chunk)
        check(key == ("ssd_chunk_sm90" if dtype == torch.bfloat16
                      else "ssd_chunk"), f"ssd {name} routed to {key}")
        got = launched(sk.LAUNCHES, key,
                       lambda: sk.forward(xw, la, bm, c, chunk=chunk))
        want = sr.intra_chunk(xw, la, bm, c, chunk=chunk)
        worst = max(worst, held(f"ssd {name} {key}", got, want, name))
        if dtype == torch.bfloat16:
            held("ssd bfloat16 ssd_chunk (before)",
                 ssd_ffma(xw, la, bm, c, chunk), want, name)
        del got, want
        y_k, s_k = so.ssd(x, dt, a, bm, c, chunk=chunk)
        y_p, s_p = ssm.ssd_chunked(x, dt, a, bm, c, chunk=chunk)
        allclose_err([(f"ops.ssd {name} y", y_k, y_p)], SSD_TOL[name])
        allclose_err([(f"ops.ssd {name} state", s_k, s_p)],
                     SSD_TOL["float32"])
        del y_k, s_k, y_p, s_p
    torch.cuda.empty_cache()

    fn = lambda: sk.forward(xw, la, bm, c, chunk=chunk)
    ffma = lambda: ssd_ffma(xw, la, bm, c, chunk)
    ms, ffma_ms = cuda_ms(fn, 20), cuda_ms(ffma, 20)
    dev_ms = device_ms(fn, 20, "ssd_chunk_sm90")
    plain_ms = cuda_ms(lambda: sr.intra_chunk(xw, la, bm, c, chunk=chunk), 3)
    ms_again = cuda_ms(fn, 20)
    bound = ssd_bound(bsz, t, h, p, n, chunk)
    print(f"ssd bf16 {bsz}x{t}x{h}x{p} N {n} L {chunk}: ssd_chunk_sm90 "
          f"{ms:.4f} / {ms_again:.4f} ms a launch (CUDA events), device "
          f"{dev_ms:.4f} ms (torch.profiler), {bound[0] / ms:.4f} of the "
          f"bound ({bound[0]:.5f} ms by {bound[1]}); ssd_chunk (before) "
          f"{ffma_ms:.4f} ms, {ffma_ms / ms:.2f}x; plain {plain_ms:.3f} ms",
          flush=True)
    by_route = {"ssd_chunk_sm90": ms, "ssd_chunk": ffma_ms}

    # zamba2-1.2b's SSM layer: d_inner 4096 in 64 heads of 64, state 64
    zh, zn = ZAMBA2["heads"], ZAMBA2["state"]
    *_, zbm, zc, zxw, zla = inputs(zh, zn, torch.bfloat16)
    check(sk.route(torch.bfloat16, p, zn, chunk) == "ssd_chunk_sm90",
          "zamba2's shape does not route to ssd_chunk_sm90")
    held("ssd bfloat16 zamba2 ssd_chunk_sm90",
         sk.forward(zxw, zla, zbm, zc, chunk=chunk),
         sr.intra_chunk(zxw, zla, zbm, zc, chunk=chunk), "bfloat16")
    zms = cuda_ms(lambda: sk.forward(zxw, zla, zbm, zc, chunk=chunk), 20)
    zffma = cuda_ms(lambda: ssd_ffma(zxw, zla, zbm, zc, chunk), 20)
    zbound = ssd_bound(bsz, t, zh, p, zn, chunk)
    print(f"ssd bf16 zamba2 {bsz}x{t}x{zh}x{p} N {zn} L {chunk}: "
          f"ssd_chunk_sm90 {zms:.4f} ms a launch, {zbound[0] / zms:.4f} of "
          f"the bound ({zbound[0]:.5f} ms by {zbound[1]}); ssd_chunk "
          f"{zffma:.4f} ms", flush=True)
    return dict(name="ssd_intra_chunk", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_sm90.cu",
                replaces="src/repro/kernels/ssd/kernel.py:65",
                max_abs_err=worst, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound=bound, library_ms=None,
                ms_by_route=by_route,
                zamba2=dict(shape=f"{bsz}x{t}x{zh}x{p}xN{zn}", ms=zms,
                            ffma_ms=zffma, bound_ms=zbound[0]))


# ---------------------------------------------------------------------------
# the DIALS paths
# ---------------------------------------------------------------------------
def make_trainer(env, side, *, device, use_kernels, small=False, rounds=1,
                 refresh=1, policy_kind="fnn", ckpt_dir=None):
    """The loop driver on ``env`` at ``side``: the library's default
    widths with a GRU AIP (``small``: narrow widths), ``DIALSConfig()``
    cut to ``rounds`` and F=``refresh``."""
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    env_mod, env_cfg = registry.make(env, side=side)
    info = env_cfg.info()
    if small:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions,
                                 kind=policy_kind, hidden=(32,),
                                 gru_hidden=16)
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru", hidden=(32,), gru_hidden=16,
                                 epochs=5)
        dc = dials.DIALSConfig(outer_rounds=rounds, aip_refresh=refresh,
                               collect_envs=4, collect_steps=32, n_envs=4,
                               rollout_steps=8, eval_episodes=2,
                               use_kernels=use_kernels, ckpt_dir=ckpt_dir)
    else:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions,
                                 kind=policy_kind)
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru")
        dc = dials.DIALSConfig(outer_rounds=rounds, aip_refresh=refresh,
                               use_kernels=use_kernels, ckpt_dir=ckpt_dir)
    return dials.DIALSTrainer(env_mod, env_cfg, pc, ac, ppo.PPOConfig(), dc,
                              device=device)


def _count_tables():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.kernels.ssd import kernel as sk
    return (gk.LAUNCHES, ak.LAUNCHES, fk.LAUNCHES, sk.LAUNCHES)


def launch_counts():
    return {k: v for table in _count_tables() for k, v in table.items()}


def reset_counts():
    from repro_torch.kernels.gru import kernel as gk
    for table in _count_tables():
        for k in table:
            table[k] = 0
    for by_shape in gk.SHAPE_LAUNCHES.values():
        by_shape.clear()


def shape_counts():
    """The GRU wrappers' launches by (A, T, B, H) since the last reset."""
    from repro_torch.kernels.gru import kernel as gk
    return {name: {"x".join(map(str, k)): n for k, n in sorted(tbl.items())}
            for name, tbl in gk.SHAPE_LAUNCHES.items()}


def round_log(label):
    def log(rec):
        phases = {k: round(rec[k], 4) for k in
                  ("collect_s", "aip_s", "inner_s", "eval_s", "round_s")}
        print(f"{label} round {rec['round']}: {phases} "
              f"gs_return={rec['gs_return']:.6f} "
              f"aip_ce {rec['aip_ce_before']:.6f}->"
              f"{rec['aip_ce_after']:.6f} "
              f"ials_reward={rec['ials_reward']:.6f} "
              f"launches so far={launch_counts()}", flush=True)
    return log


def drive_dials(label, trainer, key, rounds, kernels):
    """One run of ``trainer`` from ``key`` with every count set to 0 just
    before it and read just after; checks every round record (the fields
    of the round record, finite numbers, the kernel routing
    ``kernels``). Returns (state, history, counts, counts by shape)."""
    import torch
    from repro_torch.obs import metrics as obs_metrics
    reset_counts()
    t0 = time.perf_counter()
    state, history = trainer.run(key, log=round_log(label))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_shape = launch_counts(), shape_counts()
    print(f"{label}: {len(history)} round(s) in {wall:.3f} s, launches "
          f"{counts}; GRU launches by shape (A x T x B x H) {by_shape}",
          flush=True)
    check(len(history) == rounds, f"{label}: {len(history)} round records")
    for rec in history:
        check(set(rec) == set(obs_metrics.ROUND_KEYS),
              f"{label} round {rec['round']}: fields differ from the round "
                 f"record")
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v),
                      f"{label} round {rec['round']}: {k}={v}")
        check(rec["kernels"] == kernels,
              f"{label}: kernel routing {rec['kernels']!r}")
    for leaf in (state["aips"]["gru"]["wh"], state["ials"]["obs"]):
        check(bool(torch.isfinite(leaf.float()).all()),
              f"{label}: non-finite state")
    for name, by in by_shape.items():
        check(sum(by.values()) == counts[name],
              f"{label}: {name} launches by shape do not add up")
    return state, history, counts, by_shape


def run_main_path(device):
    """Warehouse side=10 with the FNN policy and the GRU AIP (the first
    slice's path), FNN_ROUNDS round(s)."""
    from repro_torch import random as R
    trainer = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=FNN_ROUNDS,
                           refresh=AIP_REFRESH)
    state, _, counts, by_shape = drive_dials(
        "main path", trainer, R.key(0, device=device), FNN_ROUNDS,
        "policy=cuda,aip=cuda,ppo=cuda")
    n_agents = trainer.info.n_agents
    check(tuple(state["aips"]["gru"]["wh"].shape) == (n_agents, 64, 192),
          "main path: AIP GRU weights of the wrong shape")
    for name in ("gru_forward", "gru_backward", "gae_forward"):
        check(counts[name] > 0, f"main path never launched {name}")
    return counts, by_shape


def run_gru_policy_path(device):
    """Warehouse side=10 with the paper's recurrent policy (hidden (256,
    128), gru_hidden 128) and the GRU AIP at the library defaults,
    GRU_POLICY_ROUNDS rounds: the GRU kernels at hidden 128 in the
    rollout cell and in ppo_loss. Returns (counts, by shape, the final
    state and the history) for the resume check."""
    from repro_torch import random as R
    from repro_torch.marl.ppo import PPOConfig
    trainer = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=GRU_POLICY_ROUNDS,
                           refresh=AIP_REFRESH, policy_kind="gru")
    state, history, counts, by_shape = drive_dials(
        "gru-policy path", trainer, R.key(0, device=device),
        GRU_POLICY_ROUNDS, "policy=cuda,aip=cuda,ppo=cuda")
    n_agents = trainer.info.n_agents
    wh = tuple(state["ials"]["params"]["gru"]["wh"].shape)
    check(wh == (n_agents, 128, 384),
          f"gru-policy path: policy GRU weights {wh}, not "
          f"({n_agents}, 128, 384)")
    cfg, ppo_cfg = trainer.cfg, PPOConfig()
    batch = cfg.n_envs // ppo_cfg.minibatches
    want = {"gru_forward": [(n_agents, cfg.rollout_steps, batch, 128),
                            (n_agents, 1, cfg.n_envs, 128),
                            (n_agents, 1, cfg.collect_envs, 128)],
            "gru_backward": [(n_agents, cfg.rollout_steps, batch, 128)]}
    for name, shapes in want.items():
        for shape in shapes:
            key = "x".join(map(str, shape))
            check(by_shape[name].get(key, 0) > 0,
                  f"gru-policy path never launched {name} at {key}")
    check(counts["gae_forward"] > 0, "gru-policy path never launched "
                                     "gae_forward")
    return counts, by_shape, state, history


def run_traffic_path(device):
    """Traffic side=10 (100 intersections, lane_len 8, horizon 100) with
    the paper's FNN policy and the GRU AIP at the defaults, one round at
    F=AIP_REFRESH; then the GS-trained baseline (``make_gs_trainer``,
    RunConfig(16, 16)): GS_TRAIN_STEPS ``train_fn`` steps and one
    ``eval_fn``, timed, which must launch the GAE kernel."""
    import torch
    from repro_torch import random as R
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo, runner
    from repro_torch.kernels.gae import kernel as ak
    trainer = make_trainer("traffic", SIDE, device=device, use_kernels="on",
                           rounds=1, refresh=AIP_REFRESH)
    check(trainer.env_cfg.lane_len == 8 and trainer.env_cfg.horizon == 100,
          "traffic path: not the default lane length and horizon")
    _, _, counts, by_shape = drive_dials(
        "traffic path", trainer, R.key(0, device=device), 1,
        "policy=cuda,aip=cuda,ppo=cuda")

    env_mod, env_cfg = registry.make("traffic", side=SIDE)
    info = env_cfg.info()
    init_fn, train_fn, eval_fn = runner.make_gs_trainer(
        env_mod, env_cfg, policy.PolicyConfig(info.obs_dim, info.n_actions),
        ppo.PPOConfig(), runner.RunConfig(n_envs=16, rollout_steps=16),
        device=device)
    gae_before = ak.LAUNCHES["gae_forward"]
    state = init_fn(R.key(0, device=device))
    torch.cuda.synchronize()
    times = []
    for _ in range(GS_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_fn(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ret = float(eval_fn(state["params"], R.key(1, device=device),
                        episodes=8))
    eval_s = time.perf_counter() - t0
    gae = ak.LAUNCHES["gae_forward"] - gae_before
    print(f"traffic GS baseline (E=16, T=16): train_fn steps "
          f"{[round(t, 4) for t in times]} s, eval_fn (8 episodes) "
          f"{eval_s:.4f} s, return {ret:.6f}, reward "
          f"{float(metrics['reward']):.6f}, gae_forward launches {gae}",
          flush=True)
    check(gae == GS_TRAIN_STEPS, f"GS baseline launched gae_forward {gae} "
                                 f"times in {GS_TRAIN_STEPS} steps")
    check(math.isfinite(ret) and all(
        math.isfinite(float(v)) for v in metrics.values()),
        "GS baseline: non-finite metrics")
    counts["gae_forward"] += gae
    return counts, by_shape


def run_envs_on_card(device):
    """Powergrid and supplychain at side=10 (100 buses, 100 cells): a GS
    pool trajectory of ENV_STEPS steps with auto-reset under fixed seeded
    actions on the card and on the CPU, every state field, observation,
    reward and influence bit equal; then one narrow-width DIALS round of
    each on the card."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import env_pool
    from repro_torch.envs import registry
    counts, by_shape = None, {}
    for env in ("powergrid", "supplychain"):
        mod, cfg = registry.make(env, side=SIDE)
        info = cfg.info()
        runs = {}
        for dev in ("cpu", device):
            pool = env_pool.GSPool(mod, cfg, 16)
            skeys = env_pool.stream_keys(R.key(3, device=dev), 16)
            state = pool.init(skeys)
            out = []
            for t in range(ENV_STEPS):
                k_act, k_env, k_reset = env_pool.step_keys(skeys, t, 3)
                action = R.randint(k_act, (info.n_agents,), 0,
                                   info.n_actions)
                state, obs, rew, u, done = pool.step_reset(
                    state, action, k_env, k_reset)
                out += [*(state[k] for k in sorted(state)), obs, rew, u,
                        done]
            runs[str(dev)] = [x.cpu() for x in out]
        same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                   zip(runs["cpu"], runs[str(device)]))
        print(f"{env} side={SIDE} ({info.n_agents} agents): {ENV_STEPS} GS "
              f"steps x 16 streams, card vs CPU bit for bit: {same}",
              flush=True)
        check(same, f"{env}: the card's GS trajectory differs from the CPU's")
        trainer = make_trainer(env, SIDE, device=device, use_kernels="on",
                               small=True, rounds=1, refresh=2)
        _, _, c, _ = drive_dials(f"{env} narrow round", trainer,
                                 R.key(0, device=device), 1,
                                 "policy=cuda,aip=cuda,ppo=cuda")
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    return counts, by_shape


def run_resume_path(device, straight):
    """The GRU-policy path again with ``ckpt_dir`` under build/, stopped
    after round 0; a new trainer on the same ``ckpt_dir`` with
    GRU_POLICY_ROUNDS rounds runs round 1 from the checkpoint. Its record
    and its final state against the uninterrupted run's (``straight``:
    the gru-policy path's state and history): max abs differences
    printed, expected 0, held to the CPU round tolerances."""
    import shutil
    import torch
    from repro_torch import random as R
    from repro_torch.tree import leaves
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    reset_counts()
    first = make_trainer("warehouse", SIDE, device=device, use_kernels="on",
                         rounds=1, refresh=AIP_REFRESH, policy_kind="gru",
                         ckpt_dir=d)
    first.run(R.key(0, device=device), log=round_log("resume: first run"))
    check(first.manager.steps() == [1], "resume: no checkpoint of round 0")
    resumed = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=GRU_POLICY_ROUNDS,
                           refresh=AIP_REFRESH, policy_kind="gru",
                           ckpt_dir=d)
    state, history = resumed.run(R.key(0, device=device),
                                 log=round_log("resume: resumed run"))
    counts, by_shape = launch_counts(), shape_counts()
    ref_state, ref_history = straight
    check([r["round"] for r in history] == list(range(
        1, GRU_POLICY_ROUNDS)), "resume: the resumed run's rounds")
    rec_err = {k: abs(history[0][k] - ref_history[1][k]) for k in
               ("aip_ce_before", "aip_ce_after", "gs_return",
                "ials_reward")}
    param_err = max(max_err(a, b) for a, b in zip(
        leaves(state["ials"]["params"]) + leaves(state["aips"]),
        leaves(ref_state["ials"]["params"]) + leaves(ref_state["aips"])))
    exact = [a.dtype == b.dtype and bool(torch.equal(a, b)) for a, b in zip(
        leaves(state["ials"]) + leaves(state["aips"]),
        leaves(ref_state["ials"]) + leaves(ref_state["aips"]))]
    print(f"resume on the card: round 1 record max abs diff {rec_err}, "
          f"params max abs diff {param_err:.3e}, state leaves bit for bit "
          f"equal {sum(exact)} of {len(exact)}", flush=True)
    tol = {"aip_ce_before": 1e-5, "aip_ce_after": 1e-5, "gs_return": 1e-6,
           "ials_reward": 1e-6}
    check(all(rec_err[k] <= tol[k] for k in tol) and param_err <= 1e-5,
          "resume: the resumed round differs from the uninterrupted one")
    shutil.rmtree(d, ignore_errors=True)
    return counts, by_shape


def run_serving_path(device):
    """gemma2-9b at full width, bf16, params from a seeded generator: the
    prefill step over a B=2 x T=8192 prompt with the flash kernel and
    without it, then a greedy decode. Returns the launch counts of this
    path's run."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import api
    spec = registry.get("gemma2-9b")
    flash = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, use_flash=True))
    plain = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, use_flash=False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_params(flash, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"serving: gemma2-9b init {time.perf_counter() - t0:.3f} s, "
          f"{api.param_count(params)} params, {api.param_bytes(params)} "
          f"bytes", flush=True)
    b, t = GEMMA_PROMPT
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, spec.cfg.vocab, (b, t), generator=gen,
                           device=device)
    prefill = steps.make_prefill_step(flash)

    reset_counts()
    t0 = time.perf_counter()
    logits_k = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = launch_counts()
    t0 = time.perf_counter()
    logits_p = steps.make_prefill_step(plain)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(counts["flash_attention"] == spec.cfg.n_layers,
          f"prefill launched the flash kernel {counts['flash_attention']} "
          f"times, not once per layer ({spec.cfg.n_layers})")
    check(counts["flash_fwd_sm90"] == spec.cfg.n_layers
          and counts["flash_fwd"] == 0,
          f"prefill's flash launches by kernel: {counts['flash_fwd_sm90']} "
          f"tensor-core, {counts['flash_fwd']} FFMA (all bf16: all "
          f"tensor-core)")
    check(launch_counts()["flash_attention"] == spec.cfg.n_layers,
          "the plain prefill launched the flash kernel")
    check(tuple(logits_k.shape) == (b, 1, spec.cfg.vocab),
          f"prefill logits of shape {tuple(logits_k.shape)}")
    err = allclose_err([("prefill last logits, flash vs plain", logits_k,
                         logits_p)], LOGIT_TOL)
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    print(f"serving: prefill B={b} T={t} {prefill_s:.3f} s with the flash "
          f"kernel ({counts['flash_attention']} launches), {plain_s:.3f} s "
          f"plain; last logits max abs diff {err:.4e} (max |logit| "
          f"{float(logits_p.abs().max()):.4f}), argmax agrees {agree}/{b}",
          flush=True)
    del logits_p

    serve = steps.make_serve_step(flash)
    max_len = DECODE_PROMPT + DECODE_NEW
    caches = api.init_caches(params, flash, DECODE_BATCH, max_len)
    prompt = torch.randint(0, spec.cfg.vocab, (DECODE_BATCH, DECODE_PROMPT),
                           generator=gen, device=device)
    finite = []
    t0 = time.perf_counter()
    for i in range(DECODE_PROMPT):
        logits, caches = serve(params, prompt[:, i:i + 1], caches, i)
        finite.append(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(DECODE_PROMPT, max_len - 1):
        logits, caches = serve(params, tok, caches, i)
        finite.append(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(bool(torch.stack(finite).all()), "decode: non-finite logits")
    new = torch.cat(out, dim=1)
    check(tuple(new.shape) == (DECODE_BATCH, DECODE_NEW),
          f"decode produced {tuple(new.shape)} tokens")
    peak = torch.cuda.max_memory_allocated()
    print(f"serving: decode B={DECODE_BATCH}: {DECODE_PROMPT} prompt steps "
          f"in {prompt_s:.3f} s, {DECODE_NEW} new tokens in {decode_s:.3f} "
          f"s ({DECODE_BATCH * DECODE_NEW / decode_s:.3f} tok/s, "
          f"{(DECODE_NEW - 1) / decode_s:.3f} steps/s); peak memory "
          f"{peak} bytes", flush=True)
    profile_serving(lambda: prefill(params, {"tokens": tokens}),
                    lambda i: serve(params, tok, caches, i))
    del params, caches
    torch.cuda.empty_cache()
    return counts


def device_summary(prof, wall: float, top: int = 12) -> dict:
    """Device busy share of a traced window of ``wall`` seconds (the union
    of all CUDA kernel intervals over the wall time) and device time and
    launch count per kernel name, largest first."""
    import torch
    intervals, per_kernel = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        ms, n = per_kernel.get(ev.name, (0.0, 0))
        per_kernel[ev.name] = (ms + (end - start) / 1e3, n + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_kernels": len(intervals),
            "device_busy_share": busy_us / 1e6 / wall,
            "device_ms": sum(ms for ms, _ in per_kernel.values()),
            "flash_ms": sum(ms for name, (ms, _) in per_kernel.items()
                            if "flash_fwd" in name),
            "top_kernels": [(name[:80], ms, n) for name, (ms, n) in ranked]}


def profile_serving(run_prefill, run_serve_step):
    """Where the serving path's time goes: one prefill and
    PROFILE_DECODE_STEPS serve steps (both warm), each timed untraced and
    then traced under ``torch.profiler``. Prints each window's wall
    seconds (their difference is the profiler's cost), the device busy
    share, the kernel launches, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def decode():
        for i in range(PROFILE_DECODE_STEPS):
            run_serve_step(i)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, fn in (("prefill", run_prefill),
                     (f"{PROFILE_DECODE_STEPS} decode steps", decode)):
        untraced = timed(fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(fn)
        summary = device_summary(prof, wall)
        print(f"profile {name}: untraced {untraced:.4f} s, traced "
              f"{wall:.4f} s, device busy {summary['device_busy_share']:.4f}"
              f", {summary['device_kernels']} kernels, "
              f"{summary['device_ms']:.3f} ms of kernel time, flash "
              f"{summary['flash_ms']:.3f} ms "
              f"({summary['flash_ms'] / summary['device_ms']:.4f} of it)",
              flush=True)
        for kname, ms, n in summary["top_kernels"]:
            print(f"  {ms:10.3f} ms {n:6d}x  {kname}", flush=True)


def run_ssm_path(device):
    """``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
    (2, 8192, 1536) bf16 activations, against ``use_kernel=False``: the
    counted call (one launch of ``ssd_chunk_sm90``), then one untimed
    warm-up call of each and the median of SSM_TIMED synchronised calls of
    each, then one traced kernel call for the SSD kernel's share of the
    layer's device time. Returns the launch counts of the counted call."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import common
    from repro_torch.nn import ssm
    cfg = common.ssm_layer(MAMBA2["d_model"], MAMBA2["state"],
                           head_dim=MAMBA2["head_dim"]).ssm
    gen = torch.Generator(device=device).manual_seed(2)
    params = ssm.ssm_init(gen, cfg)
    b, t = SSM_INPUT
    x = torch.randn(b, t, cfg.d_model, generator=gen,
                    device=device).to(cfg.dtype)
    layer = {k: (lambda k=k: ssm.ssm_layer(params, x, cfg, use_kernel=k))
             for k in (True, False)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    with torch.inference_mode():
        reset_counts()
        cold_s, y_k = timed(layer[True])
        counts = launch_counts()
        _, y_p = timed(layer[False])
        warm = {}
        for k, fn in layer.items():
            fn()
            warm[k] = statistics.median(timed(fn)[0]
                                        for _ in range(SSM_TIMED))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timed(layer[True])
    check(counts["ssd_intra_chunk"] == 1 and counts["ssd_chunk_sm90"] == 1
          and counts["ssd_chunk"] == 0,
          f"ssm_layer launched the SSD kernels {counts['ssd_intra_chunk']} "
          f"times ({counts['ssd_chunk_sm90']} ssd_chunk_sm90, "
          f"{counts['ssd_chunk']} ssd_chunk), not ssd_chunk_sm90 once")
    check(tuple(y_k.shape) == (b, t, cfg.d_model) and y_k.dtype == cfg.dtype,
          f"ssm_layer output {tuple(y_k.shape)} {y_k.dtype}")
    err = allclose_err([("ssm_layer, kernel vs plain", y_k, y_p)],
                       SSM_LAYER_TOL)
    spans = [(ev.name, ev.time_range.end - ev.time_range.start)
             for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    layer_us = sum(us for _, us in spans)
    ssd_us = sum(us for name, us in spans if "ssd_chunk_sm90" in name)
    print(f"ssm layer: {cfg.num_heads} heads x {cfg.head_dim}, state "
          f"{cfg.state}, chunk {cfg.chunk}, on ({b}, {t}, {cfg.d_model}) "
          f"bf16: cold {cold_s:.4f} s; warm median of {SSM_TIMED} "
          f"{warm[True] * 1e3:.3f} ms with the kernel, "
          f"{warm[False] * 1e3:.3f} ms plain; traced: {len(spans)} kernels, "
          f"{layer_us / 1e3:.3f} ms of device time, ssd_chunk_sm90 "
          f"{ssd_us / 1e3:.4f} ms ({ssd_us / layer_us:.4f} of it); max abs "
          f"diff {err:.4e} (max |y| {float(y_p.abs().max()):.4f})",
          flush=True)
    return counts


def check_small_against_plain(device):
    """One round at side=2 through the kernels and through the plain
    versions, on the card, from the same state."""
    import torch
    from repro_torch import random as R
    from repro_torch.tree import leaves
    out = {}
    for mode in ("on", "off"):
        trainer = make_trainer("warehouse", 2, device=device,
                               use_kernels=mode, small=True, rounds=1,
                               refresh=2)
        state, hist = trainer.run(R.key(1, device=device))
        out[mode] = (state, hist[0])
    (s_on, h_on), (s_off, h_off) = out["on"], out["off"]
    aip_err = max(max_err(a, b) for a, b in
                  zip(leaves(s_on["aips"]), leaves(s_off["aips"])))
    ce_err = max(abs(h_on[k] - h_off[k])
                 for k in ("aip_ce_before", "aip_ce_after"))
    print(f"small input, kernels vs plain: aip params max abs err "
          f"{aip_err:.3e}, aip CE max abs err {ce_err:.3e}, gs_return "
          f"{h_on['gs_return']:.6f} vs {h_off['gs_return']:.6f}",
          flush=True)
    check(aip_err <= 1e-4 and ce_err <= 1e-5,
          "small input: kernel path and plain path disagree")
    check(all(math.isfinite(h_on[k]) for k in
              ("gs_return", "ials_reward", "aip_ce_after")),
          "small input: non-finite record")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    # the entry points' device rule, which also sets the reference's matmul
    # numerics for the plain versions timed below
    from repro_torch.kernels import dispatch
    device = dispatch.resolve_device("cuda:0")

    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)
        return out

    try:
        smi = smi_line()
        print(f"card: {smi}", flush=True)

        from repro_torch.kernels import build
        phase("build", build.extension)
        phase("kernel resources", kernel_resources)

        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        from repro_torch.marl.ppo import PPOConfig
        ppo_cfg = PPOConfig()
        n_agents = SIDE * SIDE
        # main-path shapes: AIP training (S=7 train streams, T=128), held-
        # out eval_ce (S=1), the AIP's rollout cell (T=1, E=16), GAE over
        # N*E
        shapes = {"gru_forward": [(n_agents, 128, 7, 64),
                                  (n_agents, 128, 1, 64),
                                  (n_agents, 1, 16, 64)],
                  "gru_backward": (n_agents, 128, 7, 64),
                  # the recurrent policy at hidden 128: ppo_loss (T=16,
                  # a minibatch of 4 streams), the rollout cell (E=16),
                  # collect and eval (8 streams); BENCH_kernels.json's
                  # policy shape, and a long batch of tiles
                  "gru_h128": [(n_agents, 16, 4, 128), (n_agents, 1, 16, 128),
                               (n_agents, 1, 8, 128), (1, 16, 64, 128),
                               (1, 128, 256, 128)]}
        rows = phase("gru/gae kernels vs plain", lambda: check_gru(
            gen, device, shapes) + check_gae(
            gen, device, 16, n_agents * 16, ppo_cfg.gamma, ppo_cfg.lam))
        rows.append(phase("flash kernel vs plain", check_flash, gen, device))
        rows.append(phase("ssd kernel vs plain", check_ssd, gen, device))
        for row in rows:
            print(f"kernel {row['name']}: max abs err "
                  f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.5f} "
                  f"ms by {row['bound'][1]}, library "
                  f"{row.get('library_ms')})", flush=True)

        # each path runs with every count set to 0 just before it and
        # read just after: path -> (counts, GRU counts by shape)
        paths = {"dials warehouse fnn-policy": phase(
            "dials main path", run_main_path, device)}
        *gru_path, state, history = phase(
            "dials warehouse gru-policy path", run_gru_policy_path, device)
        paths["dials warehouse gru-policy"] = tuple(gru_path)
        paths["dials traffic"] = phase("dials traffic path",
                                       run_traffic_path, device)
        paths["envs"] = phase("envs on the card", run_envs_on_card, device)
        paths["checkpoint resume"] = phase(
            "checkpoint resume on the card", run_resume_path, device,
            (state, history))
        del state, history
        phase("dials small input vs plain", check_small_against_plain,
              device)
        paths["gemma2-9b serving"] = (phase(
            "gemma2-9b serving path", run_serving_path, device), {})
        paths["mamba2 ssm layer"] = (phase(
            "mamba2 ssm layer path", run_ssm_path, device), {})
        counts, by_shape, by_path = {}, {}, {}
        for path, (c, shapes_of) in paths.items():
            for k, n in c.items():
                counts[k] = counts.get(k, 0) + n
                if n:
                    by_path.setdefault(k, {})[path] = n
            for k, tbl in shapes_of.items():
                merged = by_shape.setdefault(k, {})
                for shape, n in tbl.items():
                    merged[shape] = merged.get(shape, 0) + n
        for name in ("gru_forward", "gru_backward", "gae_forward",
                     "flash_attention", "ssd_intra_chunk"):
            check(counts[name] > 0, f"its path never launched {name}")
    except Exception as exc:       # every phase failure ends the run
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        raise

    table = [{"name": r["name"], "route": r["route"], "source": r["source"],
              "replaces": r["replaces"], "launches": counts[r["name"]],
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1],
              "library_ms": r.get("library_ms"),
              **{k: r[k] for k in ("library", "shape", "ms_by_shape",
                                   "bound_ms_by_shape", "call_ms",
                                   "device_ms", "ms_by_route", "zamba2")
                 if k in r},
              "launches_by_path": by_path.get(r["name"], {}),
              **({"launches_by_shape": by_shape[r["name"]]}
                 if r["name"] in by_shape else {})}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
