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
     hidden 128 in the rollout cell and ppo_loss); the same path through
     the sharded round (``repro_torch.core.dials_sharded``), held against
     that loop run (AIP 1e-6, CE and IALS reward 1e-5, GS return 5e-2;
     policy 1e-6 for one shard in process, the reference's 1e-2 and
     half the loop's own move from init for two ranks), one shard in
     process, then two ranks spawned on cuda:0 over a gloo group, the
     region-
     decomposed GS splitting the ten region rows into two bands (each
     rank's round seconds, halo exchanges, staged bytes and seconds per
     round printed, its collect against the replicated collect's rows
     bit for bit, ``CollectiveFree``/``HaloOnly`` on its programs, its
     launch counts returned to the kernels line); traffic with the FNN
     policy (one round), then the GS-trained baseline (``make_gs_trainer``,
     5 timed ``train_fn`` steps and one ``eval_fn``, launching the GAE
     kernel); powergrid and supplychain, a 32-step GS trajectory each on
     the card and on the CPU, bit for bit, and one narrow-width round each;
     the recurrent-policy path again through a checkpoint: stopped after
     round 0, resumed by a new trainer for round 1, its record and state
     against the uninterrupted run (max abs differences printed); the
     recurrent-policy path with the overlapped GS collect: three rounds
     serial, three with ``async_collect=True`` (bound 2, telemetry on:
     the tags [0, 0, 1] and [True, False, False], the JSONL log valid,
     ``gru_forward`` launched by the collect worker on its own stream) and
     two at bound 0, bit for bit the serial run's records; then the
     sharded runtime's fault-tolerance half on the recurrent-policy path
     (``run_fault_path``, two ranks sharing cuda:0, re-invocations of
     this script as ``--fault-worker``): an uninterrupted run with
     distributed checkpoints (every step in the reference's per-slice
     layout), step 2 restored onto one shard and run on (bit for bit the
     loop driver's flat restore), a host drop at round 2 (the survivor's
     records and its final state bit for bit that one-shard resume, the
     event log through ``tools/telemetry_report.py --check``), a recovery
     around the external coordinator under a chaos spec (the survivor
     re-executed as generation 1, bit for bit the same, within the
     two-rank tolerances of the uninterrupted run, ``--check
     --expect-recovery``) and the dispatch-mode async collect (bound 0
     bit for bit the serial run, bound 2 tags [0, 0, 1]), with the
     recovery times and the three kernels' launches printed; then the
     kernel path against the plain path on a small input (one round,
     warehouse side=2); then the paper's experiment harness
     (``benchmarks/torch_run.py``): the ``fig3_learning`` cell of
     warehouse at the ``--fast`` sizes (DIALS, untrained-DIALS and GS
     rows, the reference's keys, finite, the GAE forward launched and
     held to its plain version at the cell's shape, T=16 x B=32),
     ``table_memory`` with its states on the card (rows equal the
     CPU's; the port's int64 columns beside the reference's), and
     ``table_lemma2``; then the program contracts
     (``repro_torch.analysis``) on the recurrent-policy warehouse and
     the traffic paths: the ring collect, the AIP round, the inner step
     and the GS eval each recorded by the op walker (ops by source line),
     run under ``set_sync_debug_mode("error")``, and captured as a CUDA
     graph whose replays (outputs fed back) must equal the eager calls
     bit for bit, eager and replay milliseconds printed (a refused
     capture of the collect or the eval is printed as a finding); the
     synchronising calls of a steady round at F=2 and F=5 by source line,
     which must match, and no kernel build after round 0;
  5. drives the serving path of gemma2-9b at full width (bf16, random
     weights from a seed): the prefill step over a B=2 x T=8192 prompt
     with the flash kernel (42 launches, all of the bf16 kernel) and
     without it, their last
     logits compared, then a greedy decode of 16 tokens at B=4 after a
     32-token prompt; then profiles the prefill and 8 decode steps
     (device busy share, device time by kernel, flash's share), each
     traced over 5 calls after a warm-up, the last 3 kept, every kept
     call's traced flash launches equal to the wrapper's count (42 a
     prefill), or the phase fails;
  6. drives ``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
     (2, 8192, 1536) bf16 activations (one launch of ``ssd_chunk_sm90``)
     against ``use_kernel=False``, then times both warm (median of 7) and
     profiles the kernel call the same way (the SSD kernel's share of its
     device time; one traced ``ssd_chunk_sm90`` launch a kept call);
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
# the overlapped collect on the recurrent-policy path: serial, async
# (bound 2) and async at bound 0 (the serial schedule)
ASYNC_ROUNDS = 3
ASYNC_ZERO_ROUNDS = 2
# The sharded path: the recurrent-policy warehouse path again through the
# sharded round, one shard in process and SHARDED_RANKS ranks sharing
# cuda:0 over gloo, held against the loop run. AIP params 1e-6, held-out CE
# 1e-5 and GS return 5e-2 are the reference's tolerances for sharded
# against loop (tests/_multidevice_check.py); the IALS reward 1e-5, as the
# CE. Policy params: 1e-6 for one shard, which runs the loop's very
# batches. The ranks run the policy's batched products over N/2 agents
# instead of N, whose last bits may differ and which the PPO steps carry
# on, so they keep the reference's 1e-2 (one optimizer step); as 1e-2 is
# more than these rounds move a parameter, the ranks' policy must also
# lie nearer the loop's than SHARDED_POLICY_REL times the loop's own move
# from init (2-norms over every leaf): a skipped or garbled update does not
SHARDED_RANKS = 2
SHARDED_TIMEOUT_S = 600
SHARDED_TOL = {"aips": 1e-6, "policy": 1e-6, "aip_ce_before": 1e-5,
               "aip_ce_after": 1e-5, "gs_return": 5e-2, "ials_reward": 1e-5}
SHARDED_RANKS_POLICY_TOL = 1e-2
SHARDED_POLICY_REL = 0.5

# The fault path (the sharded runtime's fault-tolerance half): the
# recurrent-policy warehouse path at side=10 on two ranks sharing cuda:0,
# FAULT_ROUNDS rounds a run: an uninterrupted run with checkpoints, the
# restore of step 2 onto one shard, a host drop at the top of round
# FAULT_KILL_ROUND, a recovery under FAULT_CHAOS (rank 1's writer SIGKILLed
# once its step-2 slice is prepared, its main thread parked in the round-2
# heartbeat) and the overlapped collect at bound 0 (FAULT_ZERO_ROUNDS) and
# 2 (FAULT_ASYNC_ROUNDS). The gate declares a silent rank dead after
# FAULT_BEAT_TIMEOUT_S; a collective with a stalled peer fails after the
# group's timeout FAULT_GRACE_S; a worker run is killed at FAULT_TIMEOUT_S.
FAULT_ROUNDS = 4
FAULT_KILL_ROUND = 2
FAULT_ZERO_ROUNDS = 2
FAULT_ASYNC_ROUNDS = 3
FAULT_BEAT_TIMEOUT_S = 15.0
FAULT_GRACE_S = 120.0
FAULT_TIMEOUT_S = 600
FAULT_CHAOS = "crash@2:host=1:phase=prepared,delay@2:host=1:delay_s=120"

# The contracts phase (repro_torch.analysis): the recurrent-policy
# warehouse and the traffic paths at side=10, kernels on. Four programs
# each, with the CUDA-graph replays GraphCapturable runs (the inner step
# F times, as a round runs it); the round's synchronising calls at two
# values of F. A capture the ring collect or the GS eval refuses is a
# finding (ROADMAP queue 3), not a failure; every other rule fails the run.
CONTRACT_PATHS = (("warehouse", "gru"), ("traffic", "fnn"))
CONTRACT_REPLAYS = {"ring_collect": 2, "aip_round": 3,
                    "ials_train": AIP_REFRESH, "gs_eval": 2}
MAY_REFUSE_CAPTURE = ("ring_collect", "gs_eval")
SYNC_REFRESH = (2, 5)

# The serving slice: gemma2-9b at full width (src/repro/configs/gemma2_9b.py),
# prompt B=2 x T=8192 (prefill_32k cut from B=32 x 32768), greedy decode of
# 16 tokens at B=4 after a 32-token prompt (examples/serve_decode.py).
GEMMA_PROMPT = (2, 8192)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 32, 16
# decode steps in one traced call of the serving profile (~5,000 kernels
# a step; the profiler's cost grows with the kernels it traces)
PROFILE_DECODE_STEPS = 2
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


# the marker kernel ``torch.cuda._sleep`` launches (ATen's Sleep.cu) before
# each traced call, so the device kernels split into calls by their order on
# the card alone
MARKER_KERNEL = "spin_kernel"
PROFILE_ITERS = 3


def traced_calls(fn, iters: int, count_key: str, match: str):
    """Device kernels of ``fn``'s calls: one untraced warm-up call, then
    ``iters + 2`` calls under ``torch.profiler``
    (the tracer may miss launches at its start), each after a marker
    kernel and ending in a synchronise; the last ``iters`` calls are kept.
    Each kept call must show as many launches of the kernels named
    ``match`` as the wrapper's count ``count_key`` rose by per call: a
    mismatch fails the phase. Returns [(kernels [(name, start_us,
    end_us)], host wall seconds)] for the kept calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n = iters + 2
    walls = []
    before = launch_counts()[count_key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    per_call, rest = divmod(launch_counts()[count_key] - before, n)
    check(rest == 0, f"{count_key}: {per_call * n + rest} wrapper launches "
                     f"in {n} calls")
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    calls = []
    for start, end, name in spans:
        if MARKER_KERNEL in name:
            calls.append([])
        elif calls:
            calls[-1].append((name, start, end))
    check(len(calls) >= iters, f"the profiler saw {len(calls)} of {n} "
                               f"marker kernels")
    kept = list(zip(calls[-iters:], walls[-iters:]))
    for i, (kernels, _) in enumerate(kept):
        seen = sum(match in name for name, _, _ in kernels)
        check(seen == per_call,
              f"traced call {i} of the last {iters}: {seen} launches of "
              f"{match}, the wrapper counted {per_call} a call")
    print(f"traced {n} calls, kept the last {iters}: {per_call} launches of "
          f"{match} a call, each seen by the profiler", flush=True)
    return kept


def device_ms(fn, iters: int, count_key: str, match: str):
    """Device milliseconds per launch of the kernels whose name contains
    ``match``, from ``torch.profiler``: their mean over the calls that
    ``traced_calls`` keeps (each checked against the wrapper's count
    ``count_key``): the kernel's own time, without the host's cost of the
    call."""
    kept = traced_calls(fn, iters, count_key, match)
    spans = [end - start for kernels, _ in kept
             for name, start, end in kernels if match in name]
    return sum(spans) / 1e3 / len(spans)


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
             max_abs_err=fwd_err,
             ms=device_ms(fwd, iters, "gae_forward", "gae_fwd"),
             call_ms=cuda_ms(fwd, iters),
             plain_ms=cuda_ms(
                 lambda: aref.gae_reverse_scan(r, v, nv, d, **kw), iters),
             bound=bound_ms(4.0 * 5 * n, 8.0 * n)),
        dict(name="gae_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/gae.cu",
             replaces="src/repro/kernels/gae/kernel.py:80",
             max_abs_err=bwd_err,
             ms=device_ms(bwd, iters, "gae_backward", "gae_bwd"),
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


def check_gae_forward_at(gen, device, t, b, gamma, lam) -> dict:
    """``gae_fwd`` at a path's (T, B), bit for bit against the plain
    version, with CUDA-event times of the kernel's wrapper and of the
    plain version over back-to-back calls (no profiler: at T=16 x B=32
    ``torch.profiler`` missed a share of the launches on an H100) and
    the bound."""
    import torch
    from repro_torch.kernels.gae import kernel as ak, ref as aref
    r, v, nv = (torch.randn(t, b, generator=gen, device=device)
                for _ in range(3))
    d = (torch.rand(t, b, generator=gen, device=device) < 0.05).float()
    adv_k = ak.forward(r, v, nv, d, gamma, lam)
    adv_p = aref.gae_reverse_scan(r, v, nv, d, gamma=gamma, lam=lam)
    check(torch.equal(adv_k, adv_p), f"gae_forward at {t}x{b}: not bit for "
                                     f"bit equal to the plain version")
    iters = 200
    out = {"shape": [t, b], "max_abs_err": max_err(adv_k, adv_p),
           "call_ms": cuda_ms(lambda: ak.forward(r, v, nv, d, gamma, lam),
                              iters),
           "plain_ms": cuda_ms(lambda: aref.gae_reverse_scan(
               r, v, nv, d, gamma=gamma, lam=lam), iters),
           "bound_ms": bound_ms(4.0 * 5 * t * b, 8.0 * t * b)[0]}
    print(f"gae_forward ({t}x{b}, the harness's shape): bit for bit; "
          f"{out['call_ms']:.5f} ms a call host-inclusive (CUDA events "
          f"over {iters} wrapper calls), plain {out['plain_ms']:.5f} ms, "
          f"bound {out['bound_ms']:.7f} ms", flush=True)
    return out


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
    dev_ms = device_ms(fn, 20, "ssd_chunk_sm90", "ssd_chunk_sm90")
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
                 refresh=1, policy_kind="fnn", **dials_kw):
    """The loop driver on ``env`` at ``side``: the library's default
    widths with a GRU AIP (``small``: narrow widths), ``DIALSConfig()``
    cut to ``rounds`` and F=``refresh``; ``dials_kw`` sets further
    ``DIALSConfig`` fields (``ckpt_dir``, the async collect, telemetry)."""
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
                               use_kernels=use_kernels, **dials_kw)
    else:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions,
                                 kind=policy_kind)
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru")
        dc = dials.DIALSConfig(outer_rounds=rounds, aip_refresh=refresh,
                               use_kernels=use_kernels, **dials_kw)
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
    for tables in (gk.SHAPE_LAUNCHES, gk.STREAM_LAUNCHES):
        for by_key in tables.values():
            by_key.clear()


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
              f"data_round={rec['data_round']} "
              f"forced_sync={rec['forced_sync']} "
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


# ---------------------------------------------------------------------------
# the sharded path
# ---------------------------------------------------------------------------
def _sharded_compare(label, history, aips, params, loop_history, loop_state,
                     tol, init_params=None):
    """Hold a sharded run's records and final AIP and policy params to the
    loop run's, at the tolerances ``tol`` (SHARDED_TOL's keys). With
    ``init_params``, also the policy's distance from the loop's against
    the loop's own move from init (``policy_rel``, 2-norms over every
    leaf) to SHARDED_POLICY_REL. Returns the differences."""
    from repro_torch.tree import leaves
    import torch

    def flat(tree):
        return torch.cat([torch.as_tensor(x).detach().double().cpu()
                          .reshape(-1) for x in leaves(tree)])

    def diff(a, b):
        return float((flat(a) - flat(b)).abs().max())

    errs = {"aips": diff(aips, loop_state["aips"]),
            "policy": diff(params, loop_state["ials"]["params"])}
    if init_params is not None:
        want = flat(loop_state["ials"]["params"])
        errs["policy_rel"] = float(
            (flat(params) - want).norm() / (want - flat(init_params)).norm())
    check(len(history) == len(loop_history),
          f"{label}: {len(history)} round records, the loop run has "
          f"{len(loop_history)}")
    for k in ("aip_ce_before", "aip_ce_after", "gs_return", "ials_reward"):
        errs[k] = max(abs(r[k] - q[k]) for r, q in zip(history,
                                                         loop_history))
    for rec in history:
        check(rec["n_shards"] == history[0]["n_shards"] and
              rec["collect_s"] is None and rec["inner_s"] is None,
              f"{label}: the sharded record's n_shards/phase fields")
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"{label} round {rec['round']}: "
                                        f"{k}={v}")
    print(f"{label} against the loop run: max abs differences {errs}",
          flush=True)
    limits = dict(tol)
    if init_params is not None:
        limits["policy_rel"] = SHARDED_POLICY_REL
    for k, lim in limits.items():
        check(errs[k] <= lim, f"{label}: {k} differs from the loop run by "
                              f"{errs[k]:.3e} > {lim}")
    return errs


def _sharded_rank(root, n_ranks):
    """One rank of the two-rank sharded run on cuda:0 (started by
    ``bootstrap.spawn_local``): the recurrent-policy warehouse path with
    ``shards=n_ranks`` (the region-decomposed GS under ``sharded_gs``
    auto), its launch counts and halo traffic per round; then a collect
    held against the replicated collect restricted to this rank's block,
    bit for bit, and ``CollectiveFree``/``HaloOnly`` on the round's
    programs. Returns plain values; rank 0 also its final AIP and policy
    params (gathered, every agent)."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap, collectives
    from repro_torch.kernels import build, dispatch
    from repro_torch.tree import leaves
    torch.set_num_threads(2)
    ctx = bootstrap.bootstrap()
    device = dispatch.resolve_device("cuda:0")
    t0 = time.perf_counter()
    build.extension()                      # built by the parent: a load
    load_s = time.perf_counter() - t0
    trainer = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=GRU_POLICY_ROUNDS,
                           refresh=AIP_REFRESH, policy_kind="gru",
                           shards=n_ranks)
    halo = []

    def log(rec):
        halo.append(dict(collectives.STATS))
        collectives.reset_stats()

    key = R.key(0, device=device)
    reset_counts()
    collectives.reset_stats()
    state, history = trainer.run(key, log=log)
    torch.cuda.synchronize()
    counts = launch_counts()
    runner = trainer._sharded
    # a collect on this rank against the replicated collect's rows
    init = trainer.init(key)
    carry = runner.shard_carry({"aips": init["aips"], "ials": init["ials"],
                                "reports": torch.zeros(
                                    trainer.info.n_agents, dtype=torch.int64,
                                    device=device)})
    kc = R.split(R.fold_in(key, 0), 3)[0]
    mine = runner.collect(carry["ials"]["params"], kc)
    full = trainer.collect(init["ials"]["params"], kc)
    first_diff = None
    for name in sorted(full):
        a, b = mine[name], full[name][runner.rows]
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[0].tolist()
            first_diff = (f"{name}{bad}: {a[tuple(bad)].item()} vs "
                          f"{b[tuple(bad)].item()} "
                          f"({int((a != b).sum())} of {a.numel()} differ)")
            break
    audit = None
    try:
        runner.audit_collectives(carry, key)
    except AssertionError as e:
        audit = str(e)
    out = {"rank": ctx.process_id, "world": ctx.num_processes,
           "use_sharded_gs": runner.use_sharded_gs,
           "rows": [runner.rows.start, runner.rows.stop],
           "history": history, "counts": counts, "halo": halo,
           "collect_first_diff": first_diff,
           "collect_leaves": {k: list(v.shape) for k, v in mine.items()},
           "audit": audit, "load_s": load_s}
    if ctx.process_id == 0:
        out["aips"] = leaves(state["aips"])
        out["params"] = leaves(state["ials"]["params"])
    return out


def run_sharded_path(device, smi, loop_history, loop_state):
    """The sharded round (``repro_torch.core.dials_sharded``) on the
    recurrent-policy warehouse path at side=10 (the configuration of
    ``run_gru_policy_path``, kernels on), held against that loop run:
    first one shard in process (``_run_sharded`` on a one-shard mesh,
    as the reference's own test drives it), then SHARDED_RANKS ranks
    spawned on cuda:0 over a gloo group (``bootstrap.spawn_local``),
    the warehouse's region rows split into SHARDED_RANKS bands, so the
    region-decomposed GS runs. Prints each run's round_s beside the
    loop's and the halo traffic per round. Returns (counts of the
    in-process run, {}, each rank's counts)."""
    import torch
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap
    from repro_torch.tree import leaves
    loop_round_s = [round(r["round_s"], 4) for r in loop_history]
    # (1) one shard in process
    trainer = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=GRU_POLICY_ROUNDS,
                           refresh=AIP_REFRESH, policy_kind="gru")
    key = R.key(0, device=device)
    state0 = trainer.init(key)
    init_params = [x.cpu() for x in leaves(state0["ials"]["params"])]
    reset_counts()
    state, history = trainer._run_sharded(state0, 1, log=None,
                                          straggler_mask=None)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(trainer._sharded.use_sharded_gs,
          "one shard: the region-decomposed GS did not run")
    _sharded_compare("sharded path (1 shard, in process)", history,
                     state["aips"], state["ials"]["params"], loop_history,
                     loop_state, SHARDED_TOL)
    print(f"sharded path (1 shard, in process) on {smi}: round_s "
          f"{[round(r['round_s'], 4) for r in history]} (loop "
          f"{loop_round_s}); launches {counts}", flush=True)
    for name in ("gru_forward", "gru_backward", "gae_forward"):
        check(counts[name] > 0, f"sharded path (1 shard) never launched "
                                f"{name}")
    del state, trainer
    torch.cuda.empty_cache()
    # (2) SHARDED_RANKS ranks sharing cuda:0
    t0 = time.perf_counter()
    ranks = bootstrap.spawn_local(SHARDED_RANKS, _sharded_rank, ROOT,
                                  SHARDED_RANKS, timeout_s=SHARDED_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    label = f"sharded path ({SHARDED_RANKS} ranks)"
    rank_counts = []
    for out in ranks:
        r = out["rank"]
        hist = out["history"]
        check(out["world"] == SHARDED_RANKS and out["use_sharded_gs"],
              f"{label} rank {r}: world {out['world']}, region-decomposed "
              f"GS {out['use_sharded_gs']}")
        halo = [{k: round(v, 4) if isinstance(v, float) else v
                 for k, v in h.items()} for h in out["halo"]]
        print(f"{label} rank {r} (agents {out['rows']}) on {smi}: round_s "
              f"{[round(h['round_s'], 4) for h in hist]} (loop "
              f"{loop_round_s}); halo per round {halo}; launches "
              f"{out['counts']}; kernel module load {out['load_s']:.2f} s; "
              f"collect leaves {out['collect_leaves']}", flush=True)
        check(out["collect_first_diff"] is None,
              f"{label} rank {r}: the collect differs from the replicated "
              f"collect's rows: {out['collect_first_diff']}")
        check(out["audit"] is None,
              f"{label} rank {r}: CollectiveFree/HaloOnly: {out['audit']}")
        for name in ("gru_forward", "gru_backward", "gae_forward"):
            check(out["counts"][name] > 0,
                  f"{label} rank {r} never launched {name}")
        check(all(h["halo_exchanges"] > 0 for h in out["halo"]),
              f"{label} rank {r}: a round without a halo exchange")
        timeless = [{k: v for k, v in rec.items()
                     if k not in ("round_s", "wall_s")} for rec in hist]
        check(timeless == [{k: v for k, v in rec.items()
                            if k not in ("round_s", "wall_s")}
                           for rec in ranks[0]["history"]],
              f"{label}: rank {r}'s round records differ from rank 0's")
        rank_counts.append(out["counts"])
    _sharded_compare(label, ranks[0]["history"],
                     ranks[0]["aips"], ranks[0]["params"], loop_history,
                     {"aips": leaves(loop_state["aips"]),
                      "ials": {"params": leaves(
                          loop_state["ials"]["params"])}},
                     {**SHARDED_TOL, "policy": SHARDED_RANKS_POLICY_TOL},
                     init_params=init_params)
    print(f"{label}: spawn to finish {spawn_s:.2f} s", flush=True)
    return counts, {}, rank_counts


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


def run_async_path(device, smi):
    """The recurrent-policy warehouse path (side=10, ``use_kernels="on"``,
    F=AIP_REFRESH) ASYNC_ROUNDS rounds serial, then ASYNC_ROUNDS rounds
    with the overlapped collect (``async_collect=True``,
    ``max_aip_staleness=2``, ``telemetry_dir`` under build/), then
    ASYNC_ZERO_ROUNDS rounds at ``max_aip_staleness=0``. Checks the tags
    (``data_round`` [0, 0, 1], ``forced_sync`` [True, False, False]), the
    telemetry log (every round record valid, rounds monotone, the
    run_start/collect_obtain/round/run_end events), ``gru_forward``
    launched by the collect worker on a stream other than the driver's,
    and the staleness-0 records bit for bit the serial run's."""
    import shutil
    import torch
    from repro_torch import random as R
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import sinks
    tel_dir = os.path.join(ROOT, "build", "chip_smoke_telemetry")
    shutil.rmtree(tel_dir, ignore_errors=True)
    driver = torch.cuda.current_stream(device).cuda_stream
    runs, counts = {}, None
    for label, rounds, kw in (
            ("serial", ASYNC_ROUNDS, {}),
            ("async", ASYNC_ROUNDS, dict(async_collect=True,
                                         max_aip_staleness=2,
                                         telemetry_dir=tel_dir)),
            ("staleness 0", ASYNC_ZERO_ROUNDS, dict(async_collect=True,
                                                    max_aip_staleness=0))):
        trainer = make_trainer("warehouse", SIDE, device=device,
                               use_kernels="on", rounds=rounds,
                               refresh=AIP_REFRESH, policy_kind="gru", **kw)
        _, history, c, _ = drive_dials(
            f"gru-policy {label}", trainer, R.key(0, device=device), rounds,
            "policy=cuda,aip=cuda,ppo=cuda")
        streams = dict(gk.STREAM_LAUNCHES["gru_forward"])
        runs[label] = (history, streams)
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    (serial, serial_streams), (lagged, streams), (zero, _) = runs.values()
    side = sum(n for s, n in streams.items() if s != driver)
    round_s = {label: [round(r["round_s"], 4) for r in h]
               for label, (h, _) in runs.items()}
    print(f"async collect on {smi}: round_s {round_s}; async collect_s "
          f"(obtain wait) {[round(r['collect_s'], 4) for r in lagged]}; "
          f"gru_forward launches by stream {streams} (driver {driver}): "
          f"{side} on the collect's stream", flush=True)
    check([r["data_round"] for r in lagged] == [0, 0, 1],
          "async: data_round tags are not [0, 0, 1]")
    check([r["forced_sync"] for r in lagged] == [True, False, False],
          "async: forced_sync is not [True, False, False]")
    check(set(serial_streams) == {driver},
          "serial: gru_forward launched on another stream than the driver's")
    check(side > 0, "async: the collect worker launched no gru_forward on "
                    "its own stream")
    keys = ("gs_return", "aip_ce_before", "aip_ce_after", "ials_reward",
            "data_round")
    check([[r[k] for k in keys] for r in zero] ==
          [[r[k] for k in keys] for r in serial[:ASYNC_ZERO_ROUNDS]],
          "staleness 0: the records differ from the serial run's")
    check(all(r["forced_sync"] for r in zero),
          "staleness 0: a round was not force-synced")
    events = sinks.read_jsonl(sinks.proc_path(tel_dir, 0))
    kinds = [e["event"] for e in events]
    rounds = [e for e in events if e["event"] == "round"]
    print(f"async telemetry: {len(events)} events {kinds}", flush=True)
    check(all(k in kinds for k in ("run_start", "collect_obtain", "round",
                                   "run_end")),
          "async telemetry: an event kind is missing")
    check(all(obs_metrics.validate_round(e) == [] for e in rounds),
          "async telemetry: an invalid round record")
    check([e["round"] for e in rounds] == list(range(ASYNC_ROUNDS)),
          "async telemetry: round indices not monotone")
    check([e["data_round"] for e in events
           if e["event"] == "collect_obtain"] == [0, 0, 1],
          "async telemetry: collect_obtain tags")
    shutil.rmtree(tel_dir, ignore_errors=True)
    return counts, {}


# ---------------------------------------------------------------------------
# the fault path: distributed checkpoints, host drop, recovery, async
# ---------------------------------------------------------------------------
FAULT_WORKER_MODES = ("straight", "hostdrop", "recover")


def _fault_leaves(state):
    """The state's AIP and IALS leaves on the CPU, in tree order."""
    from repro_torch.tree import leaves
    return [x.detach().cpu() for x in leaves(state["aips"])
            + leaves(state["ials"])]


def _fault_parts(state):
    """The AIP and policy leaves on the CPU (the tolerance checks')."""
    from repro_torch.tree import leaves
    return {"aips": [x.detach().cpu() for x in leaves(state["aips"])],
            "params": [x.detach().cpu()
                       for x in leaves(state["ials"]["params"])]}


def _fault_compare(label, got, want, init_params):
    """Max abs differences of the AIPs and the policy, and the policy's
    distance against the uninterrupted run's own move from init
    (``policy_rel``, 2-norms over every leaf), held to the two-rank
    tolerances (SHARDED_TOL, SHARDED_RANKS_POLICY_TOL,
    SHARDED_POLICY_REL)."""
    import torch

    def flat(xs):
        return torch.cat([x.double().reshape(-1) for x in xs])

    errs = {k: float((flat(got[k]) - flat(want[k])).abs().max())
            for k in ("aips", "params")}
    ref = flat(want["params"])
    errs["policy_rel"] = float((flat(got["params"]) - ref).norm()
                               / (ref - flat(init_params)).norm())
    for k, lim in (("aips", SHARDED_TOL["aips"]),
                   ("params", SHARDED_RANKS_POLICY_TOL),
                   ("policy_rel", SHARDED_POLICY_REL)):
        check(errs[k] <= lim, f"{label}: {k} differs by {errs[k]:.3e} > "
                              f"{lim}")
    return errs


def fault_worker(argv) -> int:
    """One rank of the fault path, started by ``run_fault_path`` as
    ``python3 chip_smoke.py --fault-worker MODE --dir D`` with the
    ``DIALS_*`` env of a two-rank gloo group on cuda:0 (the recurrent-
    policy warehouse path at side=10, kernels on, F=AIP_REFRESH):

    * ``straight``: FAULT_ROUNDS rounds with ``ckpt_dir``, then the
      overlapped collect at bound 0 (FAULT_ZERO_ROUNDS rounds) and at
      bound 2 (FAULT_ASYNC_ROUNDS rounds); the ranks leave the group
      through ``bootstrap.shutdown`` (a barrier, the destroy) and return;
    * ``hostdrop``: FAULT_ROUNDS rounds with a ``HostMonitor`` gate; rank
      1 SIGKILLs itself at the top of round FAULT_KILL_ROUND, rank 0
      trains on alone and leaves with ``os._exit(0)``;
    * ``recover``: FAULT_ROUNDS rounds with ``ckpt_dir`` under the chaos
      spec ``--chaos`` around the external coordinator; the survivor
      recovers (``recovery.recover``: finalize, teardown, re-exec of this
      very command as generation 1), runs the rest solo and writes its
      result.

    Each rank writes what it measured to ``D/rank{R}-gen{G}.pt``."""
    import argparse
    import signal
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault-worker", required=True,
                    choices=FAULT_WORKER_MODES)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--chaos", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch import obs
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap
    from repro_torch.distributed import chaos as chaos_mod
    from repro_torch.distributed import fault, recovery
    from repro_torch.kernels import build, dispatch
    torch.set_num_threads(2)
    mode, d = args.fault_worker, args.dir
    rank = int(os.environ.get("DIALS_PROCESS_ID", "0"))
    tel_dir = os.path.join(d, "tel")
    tel = (obs.Telemetry.create(tel_dir, process_id=rank)
           if mode != "straight" else obs.DISABLED)
    reco = recovery.RecoveryConfig(
        teardown_timeout_s=5.0, init_timeout_s=180.0, retries=4,
        backoff_s=0.5, peer_death_grace_s=FAULT_GRACE_S)
    if mode == "recover":
        ctx, gen = recovery.startup(reco=reco, telemetry=tel)
    else:
        ctx, gen = bootstrap.bootstrap(peer_death_grace_s=FAULT_GRACE_S,
                                       init_timeout_s=180.0), 0
    device = dispatch.resolve_device("cuda:0")
    build.extension()                      # built by the parent: a load
    key = R.key(0, device=device)
    out = {"rank": rank, "gen": gen, "world": ctx.num_processes}
    path = os.path.join(d, f"rank{rank}-gen{gen}.pt")
    ends = {}

    def log(rec):
        ends[rec["round"]] = time.time()

    def trainer_for(rounds, **kw):
        return make_trainer("warehouse", SIDE, device=device,
                            use_kernels="on", rounds=rounds,
                            refresh=AIP_REFRESH, policy_kind="gru", **kw)

    def finish(state, history):
        torch.cuda.synchronize()
        out.update(history=history, counts=launch_counts(),
                   ends=dict(ends))
        if state is not None:
            out["state"] = _fault_leaves(state)
            out["parts"] = _fault_parts(state)

    if mode == "straight":
        trainer = trainer_for(FAULT_ROUNDS,
                              ckpt_dir=os.path.join(d, "ckpt"),
                              ckpt_keep=FAULT_ROUNDS)
        reset_counts()
        state, history = trainer.run(key, log=log)
        finish(state if rank == 0 else None, history)
        out["save"] = trainer._dist_manager.timings
        runs = {}
        for label, rounds, bound in (("bound0", FAULT_ZERO_ROUNDS, 0),
                                     ("bound2", FAULT_ASYNC_ROUNDS, 2)):
            del trainer, state
            torch.cuda.empty_cache()
            trainer = trainer_for(rounds, async_collect=True,
                                  max_aip_staleness=bound)
            reset_counts()
            state, history = trainer.run(key)
            torch.cuda.synchronize()
            runs[label] = {"history": history, "counts": launch_counts()}
            if rank == 0:
                runs[label]["state"] = _fault_leaves(state)
        out["async"] = runs
        torch.save(out, path)
        bootstrap.shutdown()
        return 0

    if mode == "hostdrop":
        monitor = fault.HostMonitor(
            os.path.join(d, "beats"), host=rank, n_hosts=2,
            timeout_s=FAULT_BEAT_TIMEOUT_S, telemetry=tel)
        trainer = trainer_for(FAULT_ROUNDS, telemetry_dir=tel_dir)
        waits = {}

        def heartbeats(rnd):
            if rank == 1 and rnd >= FAULT_KILL_ROUND:
                # rounds 0..1 and their mirror all-gathers are done on
                # both ranks: die without a trace
                with open(os.path.join(d, "killed_at"), "w") as f:
                    f.write(repr(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            dead = monitor.gate(rnd)
            waits[rnd] = monitor.last_wait_s
            if dead:
                out["detected_at"] = time.time()
            return dead

        reset_counts()
        state, history = trainer.run(key, heartbeats=heartbeats, log=log)
        finish(state, history)
        out["gate_wait_s"] = waits
        tel.close()
        torch.save(out, path)
        print("FAULT-WORKER-OK", flush=True)
        os._exit(0)       # no leaving the group next to a dead peer

    # recover
    trainer = trainer_for(FAULT_ROUNDS, ckpt_dir=os.path.join(d, "ckpt"),
                          ckpt_keep=FAULT_ROUNDS, telemetry_dir=tel_dir)
    schedule = chaos_mod.FaultSchedule.from_spec(
        args.chaos, host=ctx.process_id, generation=gen, telemetry=tel)
    heartbeats, deadman = None, None
    if ctx.num_processes > 1:
        monitor = fault.HostMonitor(
            os.path.join(d, "beats"), host=ctx.process_id,
            n_hosts=ctx.num_processes, timeout_s=FAULT_BEAT_TIMEOUT_S,
            telemetry=tel)
        heartbeats = recovery.raising_gate(monitor)
        deadman = recovery.Deadman(
            os.path.join(d, "beats"), host=ctx.process_id,
            n_hosts=ctx.num_processes,
            current_round=lambda: heartbeats.round,
            on_loss=lambda loss: recovery.recover(
                loss, ctx, ckpt_dir=os.path.join(d, "ckpt"), reco=reco,
                telemetry=tel),
            interval_s=1.0, silence_s=FAULT_GRACE_S / 2,
            telemetry=tel).start()
    reset_counts()
    try:
        state, history = trainer.run(key, heartbeats=heartbeats,
                                     chaos=schedule, log=log)
        if deadman is not None:
            deadman.stop()
    except Exception as err:
        loss = recovery.diagnose(err, heartbeats, telemetry=tel)
        if deadman is not None and not deadman.claim():
            import threading
            threading.Event().wait()      # the watchdog is recovering
        recovery.recover(loss, ctx, ckpt_dir=os.path.join(d, "ckpt"),
                         reco=reco, telemetry=tel)
        raise AssertionError("recover() returned")
    if gen == 0:
        print("FAULT-WORKER: the scheduled fault never fired", flush=True)
        return 1
    finish(state, history)
    tel.close()
    torch.save(out, path)
    print("FAULT-WORKER-OK", flush=True)
    return 0


def _fault_env(port, rank, external=False):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "DIALS_COORDINATOR": f"127.0.0.1:{port}",
           "DIALS_NUM_PROCESSES": "2", "DIALS_PROCESS_ID": str(rank)}
    env.pop("DIALS_RECOVERY_GENERATION", None)
    env.pop("DIALS_COORDINATOR_EXTERNAL", None)
    if external:
        env["DIALS_COORDINATOR_EXTERNAL"] = "1"
    return env


def _fault_ranks(mode, d, *, port=None, external=False, chaos=""):
    """Two worker ranks of ``fault_worker``; returns [(rc, output)] by
    rank. Every rank still running at FAULT_TIMEOUT_S is killed."""
    from repro_torch.distributed import bootstrap
    port = port if port is not None else bootstrap.free_port()
    os.makedirs(d, exist_ok=True)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
           "--fault-worker", mode, "--dir", d]
    if chaos:
        cmd += ["--chaos", chaos]
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=_fault_env(port, r,
                                                            external),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    deadline = time.monotonic() + FAULT_TIMEOUT_S
    out = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(d, f"rank{r}.log")) as f:
            out.append((p.returncode, f.read()))
    return out


def _fault_load(d, rank, gen=0):
    import torch
    return torch.load(os.path.join(d, f"rank{rank}-gen{gen}.pt"),
                      weights_only=False)


def _fault_check_ok(label, results, want=(0, 0)):
    for r, ((rc, log), code) in enumerate(zip(results, want)):
        check(rc == code, f"{label}: rank {r} exited with {rc}, not {code}:"
                          f"\n{log[-3000:]}")


def _fault_kernels(label, counts):
    for name in ("gru_forward", "gru_backward", "gae_forward"):
        check(counts.get(name, 0) > 0, f"{label} never launched {name}")


def _telemetry_report(directory, *flags):
    """``tools/telemetry_report.py`` (the repo's own check of an event
    log) on ``directory``, in a process of its own."""
    proc = subprocess.run(
        [sys.executable, "-m", "tools.telemetry_report", directory,
         "--check", *flags], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        timeout=120)
    print(f"telemetry_report {os.path.basename(directory)} "
          f"{' '.join(flags)}: {proc.stdout.strip()[-300:]}", flush=True)
    check(proc.returncode == 0, f"telemetry_report --check {flags} failed "
                                f"on {directory}:\n{proc.stdout[-2000:]}"
                                f"{proc.stderr[-2000:]}")


def _fault_events(directory):
    from repro_torch.obs import sinks
    return sinks.read_jsonl(sinks.merge_dir(directory))


def _same(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def run_fault_path(device, smi):
    """The sharded runtime's fault-tolerance half on the recurrent-policy
    warehouse path at side=10 (kernels on, F=AIP_REFRESH), two ranks
    sharing cuda:0 over gloo (``fault_worker``):

    1. an uninterrupted run of FAULT_ROUNDS rounds with ``ckpt_dir``:
       every step in the reference's layout (one slice per rank,
       ``replicated/``, a verifying COMMIT);
    2. in this process, step 2 restored into a one-shard runner (two
       slices onto one shard, a ``restore_reshard`` event) and run on for
       rounds 2..; the loop driver's flat-manager restore of the same
       step bit for bit the one-shard restore;
    3. a host drop: rank 1 SIGKILLed at the top of round 2, the survivor
       reassigned (records n_shards [2, 2, 1, 1], dead_hosts [1],
       reassigned 1) and bit for bit (2)'s final state; the merged event
       log passing ``tools/telemetry_report.py --check`` with its
       ``host_death`` and ``elastic_reassign``;
    4. a recovery around the external coordinator under the chaos spec
       FAULT_CHAOS: rank 1 SIGKILLed (-9), the survivor re-executed as
       generation 1, resuming rounds [2, 3] solo, bit for bit (2)'s final
       state, within the two-rank tolerances of (1), the merged log
       passing ``--check --expect-recovery``;
    5. the sharded overlapped collect: bound 0 bit for bit (1)'s records
       and state over the same rounds, bound 2 tags [0, 0, 1].

    Prints each rank's round_s and mirror_s, the saves' prepare and
    commit seconds, the restore seconds, the gate's wait until the death
    was declared, the seconds from the SIGKILL to the survivor's first
    resumed round, and each run's launches of the three kernels. Returns
    (the launch counts of every run of the phase, {})."""
    import shutil
    import torch
    from repro_torch import random as R
    from repro_torch.checkpoint import distributed as dckpt
    from repro_torch.obs import sinks
    base = os.path.join(ROOT, "build", "chip_smoke_fault")
    shutil.rmtree(base, ignore_errors=True)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def round_s(hist):
        return [round(r["round_s"], 4) for r in hist]

    # (1) + (5): the uninterrupted run, then the overlapped collect
    d1 = os.path.join(base, "straight")
    t0 = time.perf_counter()
    results = _fault_ranks("straight", d1)
    _fault_check_ok("fault (1) straight", results)
    ranks = [_fault_load(d1, r) for r in range(2)]
    print(f"fault (1) straight: 2 ranks spawn to finish "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for out in ranks:
        r = out["rank"]
        saves = [(t["step"], round(t["prepare_s"], 4),
                  t["commit_s"] and round(t["commit_s"], 4))
                 for t in out["save"]]
        print(f"fault (1) rank {r} on {smi}: round_s "
              f"{round_s(out['history'])}; saves (step, prepare s, "
              f"commit s) {saves}; launches {out['counts']}", flush=True)
        check([x["n_shards"] for x in out["history"]] == [2] * FAULT_ROUNDS,
              f"fault (1) rank {r}: n_shards")
        _fault_kernels(f"fault (1) rank {r}", out["counts"])
        add(out["counts"])
    ck1 = os.path.join(d1, "ckpt")
    check(sorted(os.listdir(ck1)) == [f"step_{s}" for s in
                                      range(1, FAULT_ROUNDS + 1)],
          f"fault (1): steps {sorted(os.listdir(ck1))}")
    n, half = SIDE * SIDE, SIDE * SIDE // 2
    for s in range(1, FAULT_ROUNDS + 1):
        sd = os.path.join(ck1, f"step_{s}")
        names = sorted(os.listdir(sd))
        check(names == ["COMMIT", f"agents-00000-{half:05d}",
                        f"agents-{half:05d}-{n:05d}", "replicated"],
              f"fault (1) step {s}: {names}")
        meta = dckpt.committed_meta(sd)
        check(meta is not None and meta["slices"] == [[0, half], [half, n]]
              and meta["replicated"] == ["key.npy", "round.npy"],
              f"fault (1) step {s}: COMMIT does not verify: {meta}")
    straight_parts = ranks[0]["parts"]

    # (2) restore step 2: one shard in this process, and the loop driver
    d2 = os.path.join(base, "one_shard")
    os.makedirs(os.path.join(d2, "ckpt"))
    shutil.copytree(os.path.join(ck1, "step_2"),
                    os.path.join(d2, "ckpt", "step_2"))
    key = R.key(0, device=device)
    one = make_trainer("warehouse", SIDE, device=device, use_kernels="on",
                       rounds=FAULT_ROUNDS, refresh=AIP_REFRESH,
                       policy_kind="gru", ckpt_dir=os.path.join(d2, "ckpt"),
                       telemetry_dir=os.path.join(d2, "tel"))
    runner = one._sharded_runner(1)
    t0 = time.perf_counter()
    restored = one.restore_or_init(key, runner=runner)
    torch.cuda.synchronize()
    restore_one_s = time.perf_counter() - t0
    loop = make_trainer("warehouse", SIDE, device=device, use_kernels="on",
                        rounds=FAULT_ROUNDS, refresh=AIP_REFRESH,
                        policy_kind="gru", ckpt_dir=os.path.join(d2, "ckpt"))
    t0 = time.perf_counter()
    flat = loop.restore_or_init(key)
    torch.cuda.synchronize()
    restore_flat_s = time.perf_counter() - t0
    check(restored["round"] == flat["round"] == 2,
          f"fault (2): restored rounds {restored['round']}, {flat['round']}")
    check(_same(_fault_leaves(restored), _fault_leaves(flat)) and
          torch.equal(restored["key"], flat["key"]),
          "fault (2): the loop driver's restore differs from the one-shard "
          "restore")
    del loop, flat, restored
    reset_counts()
    state, history = one._run_sharded(None, 1, key=key, log=None,
                                      straggler_mask=None)
    torch.cuda.synchronize()
    counts = launch_counts()
    _fault_kernels("fault (2) one shard", counts)
    add(counts)
    check([x["round"] for x in history] == list(range(2, FAULT_ROUNDS)),
          f"fault (2): rounds {[x['round'] for x in history]}")
    reshard = [e for e in sinks.read_jsonl(sinks.proc_path(
        os.path.join(d2, "tel"), 0)) if e["event"] == "restore_reshard"]
    check(bool(reshard) and (reshard[0]["old_shards"],
                             reshard[0]["new_shards"]) == (2, 1),
          f"fault (2): restore_reshard events {reshard}")
    ref_state = _fault_leaves(state)
    print(f"fault (2) restore of step 2 on {smi}: one shard "
          f"{restore_one_s:.4f} s, loop driver (flat manager) "
          f"{restore_flat_s:.4f} s; one-shard round_s {round_s(history)}; "
          f"launches {counts}", flush=True)
    del one, state, runner
    torch.cuda.empty_cache()

    # (3) host drop
    d3 = os.path.join(base, "hostdrop")
    t0 = time.perf_counter()
    results = _fault_ranks("hostdrop", d3)
    _fault_check_ok("fault (3) hostdrop", results, want=(0, -9))
    out = _fault_load(d3, 0)
    hist = out["history"]
    with open(os.path.join(d3, "killed_at")) as f:
        killed_at = float(f.read())
    print(f"fault (3) host drop survivor on {smi}: round_s "
          f"{round_s(hist)}; mirror_s "
          f"{[round(x['mirror_s'], 4) for x in hist]}; gate wait by round "
          f"{ {k: round(v, 4) for k, v in out['gate_wait_s'].items()} }; "
          f"SIGKILL to death declared "
          f"{out['detected_at'] - killed_at:.3f} s, to the end of the "
          f"first resumed round {out['ends'][FAULT_KILL_ROUND] - killed_at:.3f}"
          f" s; spawn to finish {time.perf_counter() - t0:.2f} s; launches "
          f"{out['counts']}", flush=True)
    _fault_kernels("fault (3) survivor", out["counts"])
    add(out["counts"])
    check([x["n_shards"] for x in hist] == [2, 2, 1, 1],
          f"fault (3): n_shards {[x['n_shards'] for x in hist]}")
    check([x["dead_hosts"] for x in hist] == [[], [], [1], []],
          f"fault (3): dead_hosts {[x['dead_hosts'] for x in hist]}")
    check([x["reassigned"] for x in hist] == [0, 0, 1, 0],
          f"fault (3): reassigned {[x['reassigned'] for x in hist]}")
    check(_same(out["state"], ref_state),
          "fault (3): the survivor's final state is not bit for bit the "
          "one-shard resume from step 2")
    _telemetry_report(os.path.join(d3, "tel"))
    events = _fault_events(os.path.join(d3, "tel"))
    for r in range(2):
        recs = [e for e in events if e["event"] == "round"
                and e["proc"] == r]
        print(f"fault (3) rank {r} round records: round_s "
              f"{round_s(recs)}, mirror_s "
              f"{[round(e['mirror_s'], 4) for e in recs]}", flush=True)
    kinds = {e["event"] for e in events}
    check({"host_death", "elastic_reassign"} <= kinds,
          f"fault (3): events {sorted(kinds)}")

    # (4) recovery around the external coordinator
    from repro_torch.distributed import bootstrap
    d4 = os.path.join(base, "recover")
    os.makedirs(d4)
    port = bootstrap.free_port()
    ready = os.path.join(d4, "coordinator.ready")
    coordinator = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.coordinator",
         "--bind", f"127.0.0.1:{port}", "--num-processes", "2",
         "--ready-file", ready, "--timeout-s", str(FAULT_TIMEOUT_S)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT,
                                                                "src")},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(1200):
            if os.path.exists(ready) or coordinator.poll() is not None:
                break
            time.sleep(0.05)
        check(os.path.exists(ready), "fault (4): the coordinator never "
                                     "came up")
        t0 = time.perf_counter()
        results = _fault_ranks("recover", d4, port=port, external=True,
                               chaos=FAULT_CHAOS)
    finally:
        coordinator.terminate()
        try:
            coordinator.wait(timeout=30)
        except subprocess.TimeoutExpired:
            coordinator.kill()
            coordinator.wait()
    _fault_check_ok("fault (4) recover", results, want=(0, -9))
    check("FAULT-WORKER-OK" in results[0][1], "fault (4): no result")
    out = _fault_load(d4, 0, gen=1)
    hist = out["history"]
    check((out["gen"], out["world"]) == (1, 1),
          f"fault (4): generation {out['gen']}, world {out['world']}")
    check([x["round"] for x in hist] == list(range(2, FAULT_ROUNDS)),
          f"fault (4): resumed rounds {[x['round'] for x in hist]}")
    _fault_kernels("fault (4) survivor", out["counts"])
    add(out["counts"])
    check(_same(out["state"], ref_state),
          "fault (4): the survivor's final state is not bit for bit the "
          "one-shard resume from step 2")
    from repro_torch.tree import leaves
    init = make_trainer("warehouse", SIDE, device=device, use_kernels="on",
                        rounds=1, refresh=AIP_REFRESH, policy_kind="gru")
    init_params = [x.cpu() for x in
                   leaves(init.init(key)["ials"]["params"])]
    errs = _fault_compare("fault (4) survivor against (1)", out["parts"],
                          straight_parts, init_params)
    del init
    _telemetry_report(os.path.join(d4, "tel"), "--expect-recovery")
    events = _fault_events(os.path.join(d4, "tel"))

    def first_t(name, **where):
        for e in events:
            if e["event"] == name and all(e.get(k) == v
                                          for k, v in where.items()):
                return e["t"]
        raise PhaseError(f"fault (4): no {name} event {where}")

    t_kill = first_t("chaos_inject", kind="writer_crash")
    t_death = first_t("host_death")
    t_boot = first_t("rebootstrap")
    t_start = [e["t"] for e in events if e["event"] == "run_start"][-1]
    t_round = first_t("round", round=2)
    print(f"fault (4) recovery on {smi}: SIGKILL to death declared "
          f"{t_death - t_kill:.3f} s, to the re-executed bootstrap "
          f"{t_boot - t_kill:.3f} s, to the resumed run_start "
          f"{t_start - t_kill:.3f} s, to the end of the first resumed round "
          f"{t_round - t_kill:.3f} s; generation 1 round_s {round_s(hist)}; "
          f"against (1): {errs}; spawn to finish "
          f"{time.perf_counter() - t0:.2f} s; launches {out['counts']}",
          flush=True)

    # (5) the overlapped collect on the two ranks of (1)
    keys = ("gs_return", "aip_ce_before", "aip_ce_after", "ials_reward",
            "data_round", "stale_forced", "staleness_min", "staleness_mean",
            "staleness_max", "n_shards")
    step2, _ = _restore_full(device, ck1, 2)
    for out in ranks:
        r, runs = out["rank"], out["async"]
        zero, lag = runs["bound0"]["history"], runs["bound2"]["history"]
        for label in ("bound0", "bound2"):
            _fault_kernels(f"fault (5) rank {r} {label}",
                           runs[label]["counts"])
            add(runs[label]["counts"])
        print(f"fault (5) rank {r} on {smi}: bound 0 round_s "
              f"{round_s(zero)}, bound 2 round_s {round_s(lag)}, obtain "
              f"wait {[round(x['collect_s'], 4) for x in lag]}; tags "
              f"{[x['data_round'] for x in lag]}", flush=True)
        check([[x[k] for k in keys] for x in zero] ==
              [[x[k] for k in keys]
               for x in out["history"][:FAULT_ZERO_ROUNDS]],
              f"fault (5) rank {r}: bound-0 records differ from (1)'s")
        check(all(x["forced_sync"] for x in zero),
              f"fault (5) rank {r}: a bound-0 round was not force-synced")
        check([x["data_round"] for x in lag] == [0, 0, 1] and
              [x["forced_sync"] for x in lag] == [True, False, False],
              f"fault (5) rank {r}: bound-2 tags "
              f"{[x['data_round'] for x in lag]}")
    check(_same(ranks[0]["async"]["bound0"]["state"], step2),
          "fault (5): the bound-0 state is not bit for bit (1)'s step 2")
    for k in ("gru_forward", "gru_backward", "gae_forward"):
        check(total.get(k, 0) > 0, f"fault path never launched {k}")
    return total, {}


def _restore_full(device, directory, step):
    """Step ``step`` of ``directory`` as full AIP and IALS leaves (the
    flat manager's restore into the gru-policy trainer's state)."""
    from repro_torch import random as R
    tr = make_trainer("warehouse", SIDE, device=device, use_kernels="on",
                      rounds=1, refresh=AIP_REFRESH, policy_kind="gru",
                      ckpt_dir=directory)
    tree, got = tr.manager.restore_step(step, tr.init(R.key(0,
                                                            device=device)))
    check(got == step, f"no committed step {step} in {directory}")
    return _fault_leaves(tree), got


def run_contracts_path(device, smi):
    """The program contracts on the card (``repro_torch.analysis``), for
    each of CONTRACT_PATHS at side=10 with ``use_kernels="on"``: for the
    ring collect (``collect_into``), the AIP round, the inner step and the
    GS eval, one call under the op walker (its census: ops by source
    line), ``NoHostSync`` (nothing exempt; one call under
    ``set_sync_debug_mode("error")``) and ``GraphCapturable`` (eager calls
    on a side stream, a capture, as many replays with the outputs fed
    back, bit for bit; eager and replay medians by CUDA events). Then two
    rounds at each F of SYNC_REFRESH under ``SyncCounter`` and
    ``CompileCounter``: the synchronising calls of the steady round 1 by
    source line must not grow with F (``ScalarSyncBudget``) and no kernel
    build may follow round 0. Returns (counts, by shape): the launches of
    the walker's, the eager calls' and the captures', not the graph
    replays'."""
    from repro_torch import random as R
    from repro_torch.analysis import contracts, programs, recompile, walker
    from repro_torch.analysis.report import format_finding
    reset_counts()
    refusals, table = [], {}
    for env, kind in CONTRACT_PATHS:
        label = f"{env}/{kind}-policy"
        trainer = make_trainer(env, SIDE, device=device, use_kernels="on",
                               rounds=2, refresh=AIP_REFRESH,
                               policy_kind=kind)
        progs = {p.name.rsplit("/", 1)[1]: p
                 for p in programs.loop_programs(env, trainer=trainer)}
        for name, replays in CONTRACT_REPLAYS.items():
            program = progs[name]
            program.meta["replays"] = replays
            rec = program.recording()
            start = launch_counts()
            # one eager call under the sync-debug mode
            sync = contracts.NoHostSync().check(program)
            mid = launch_counts()
            for f in sync:
                print(format_finding(f, github=False), flush=True)
            check(not sync, f"contracts {label} {name}: NoHostSync")
            # `replays` eager calls, the capture, `replays` replays: what
            # the eager calls do not account for was launched into the
            # graph (replays launch through it, uncounted)
            graph = contracts.GraphCapturable().check(program)
            end = launch_counts()
            inside = {k: end[k] - mid[k] - replays * (mid[k] - start[k])
                      for k in end if end[k] > mid[k]}
            for f in graph:
                print(format_finding(f, github=False), flush=True)
            refused = [f for f in graph if "cannot be captured" in f.message]
            if refused and name in MAY_REFUSE_CAPTURE:
                refusals += [format_finding(f, github=False)
                             for f in refused]
                graph = [f for f in graph if f not in refused]
            check(not graph, f"contracts {label} {name}: GraphCapturable")
            t = program.meta.get("timing", {})
            row = {"ops": len(rec.sites),
                   "host_reads": len(walker.host_reads(rec)),
                   "eager_ms": t.get("eager_median_ms"),
                   "replay_ms": t.get("replay_median_ms"),
                   "eager_ms_all": t.get("eager_ms"),
                   "replay_ms_all": t.get("replay_ms"),
                   "launches_in_graph": inside if not refused else None,
                   "census": walker.census(rec, 10),
                   "functions": walker.census(rec, 3, by="fn")}
            table[f"{label} {name}"] = row
            print(f"contracts {label} {name} on {smi}: {row['ops']} ops "
                  f"({row['host_reads']} host reads), eager "
                  f"{row['eager_ms']} ms, replay {row['replay_ms']} ms "
                  f"(medians of {replays}; all {row['eager_ms_all']} / "
                  f"{row['replay_ms_all']}), kernel launches inside the "
                  f"graph {inside}; ops by line {row['census']}; by "
                  f"function {row['functions']}",
                  flush=True)
            if name in ("ials_train", "aip_round"):
                want = ["gru_forward", "gru_backward"] if (
                    name == "aip_round" or kind == "gru") else \
                    ["gru_forward"]
                want += ["gae_forward"] if name == "ials_train" else []
                check(all(inside.get(k, 0) > 0 for k in want),
                      f"contracts {label} {name}: {want} not all inside "
                      f"the captured graph ({inside})")
        del progs, program, rec
        counts, record = {}, None
        for refresh in SYNC_REFRESH:
            tr = make_trainer(env, SIDE, device=device, use_kernels="on",
                              rounds=2, refresh=refresh, policy_kind=kind)
            snaps, compiles = [], []
            with recompile.CompileCounter() as cc, \
                    contracts.SyncCounter() as sc:
                _, history = tr.run(R.key(0, device=device), log=lambda r: (
                    snaps.append(sc.snapshot()), compiles.append(cc.count)))
            counts[refresh] = snaps[1] - snaps[0]
            record = history[-1]
            steady = recompile.check_steady_state(
                compiles, what=f"contracts {label} F={refresh}")
            print(f"contracts {label} F={refresh}: synchronising calls of "
                  f"steady round 1: {sum(counts[refresh].values())} "
                  f"{dict(sorted(counts[refresh].items()))}; compiles per "
                  f"round {compiles}; round_s "
                  f"{[round(r['round_s'], 4) for r in history]}",
                  flush=True)
            for f in steady:
                print(format_finding(f, github=False), flush=True)
            check(not steady, f"contracts {label}: a compile after round 0")
        budget = contracts.ScalarSyncBudget().check(contracts.Program(
            f"loop/{env}/round", ("round",),
            meta={"record": record, "sync_counts": counts}))
        for f in budget:
            print(format_finding(f, github=False), flush=True)
        check(not budget, f"contracts {label}: ScalarSyncBudget")
        table[f"{label} syncs"] = {f: dict(c) for f, c in counts.items()}
    print(f"contracts summary on {smi}: "
          f"{json.dumps(table, default=str)}", flush=True)
    for line in refusals:
        print(f"contracts finding (ROADMAP queue 3): {line}", flush=True)
    return launch_counts(), shape_counts()


# ---------------------------------------------------------------------------
# the paper's experiment harness (benchmarks/torch_run.py)
# ---------------------------------------------------------------------------
# torch_run.py's --fast fig3_learning sizes (benchmarks/run.py:78-79)
HARNESS_ENV, HARNESS_ROUNDS, HARNESS_INNER = "warehouse", 3, 10
HARNESS_DIALS_KEYS = {"label", "final_gs_return", "best_gs_return",
                      "aip_ce_final", "wall_s"}


def _quiet_bench(fn, *args, **kw):
    """A torch_run table, its JSON under build/ and its lines swallowed."""
    import contextlib
    import io
    d = os.path.join(ROOT, "build", "chip_smoke_harness")
    os.makedirs(d, exist_ok=True)
    with contextlib.chdir(d), contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def run_harness_path(device):
    """The paper's experiment harness on the card (``benchmarks/
    torch_run.py``): ``fig3_env_rows`` for warehouse at the ``--fast``
    sizes (HARNESS_ROUNDS rounds of F=HARNESS_INNER, the reference's
    widths: an FNN AIP and policy, so the GAE forward is the kernel this
    path launches), kernels on, its DIALS, untrained-DIALS and GS rows
    checked for the reference's keys and finite values; ``table_memory``
    with its states initialised on the card (``torch_run.state_bytes``
    raises on a leaf that is not there), its rows equal to the same on
    the CPU, the port's int64 columns at least the reference's; and
    ``table_lemma2`` (float64, CPU), every certificate holding. Returns
    the launch counts of the fig3 cell's run."""
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks import torch_run
    reset_counts()
    t0 = time.perf_counter()
    rows = torch_run.fig3_env_rows(HARNESS_ENV, rounds=HARNESS_ROUNDS,
                                   inner=HARNESS_INNER, device=device,
                                   use_kernels="on")
    torch.cuda.synchronize()
    cell_s = time.perf_counter() - t0
    counts = launch_counts()
    check([r["label"] for r in rows] == [
        f"DIALS-{HARNESS_ENV}", f"untrained-DIALS-{HARNESS_ENV}",
        f"GS-{HARNESS_ENV}"], f"fig3 rows {[r['label'] for r in rows]}")
    for r in rows:
        want = (HARNESS_DIALS_KEYS if "DIALS" in r["label"] else
                {"label", "final_gs_return", "wall_s"})
        check(set(r) == want, f"fig3 row {r['label']}: keys {sorted(r)}")
        for k, v in r.items():
            check(k == "label" or math.isfinite(v),
                  f"fig3 row {r['label']}: {k}={v}")
        print(f"harness fig3 {r['label']}: " + ", ".join(
            f"{k}={v:.6f}" for k, v in r.items() if k != "label"),
            flush=True)
    check(counts["gae_forward"] > 0, "the fig3 cell never launched "
                                     "gae_forward")
    print(f"harness fig3 cell ({HARNESS_ROUNDS} rounds of F={HARNESS_INNER},"
          f" DIALS + untrained-DIALS + {HARNESS_ROUNDS * HARNESS_INNER} GS "
          f"steps): {cell_s:.3f} s, launches {counts}", flush=True)
    t0 = time.perf_counter()
    on_card = _quiet_bench(torch_run.table_memory, device=device)
    on_cpu = _quiet_bench(torch_run.table_memory, device="cpu")
    check(on_card == on_cpu, "table_memory: the card's rows differ from the "
                             "CPU's")
    check(all(r[k + "_port"] >= r[k] > 0 for r in on_card for k in
              ("gs_state_bytes", "ls_state_bytes_per_agent")),
          f"table_memory: port bytes below the reference's {on_card}")
    lemma = _quiet_bench(torch_run.table_lemma2)
    check(len(lemma) == 5 and all(
        r["holds"] == 1 and all(math.isfinite(r[k]) for k in
                                ("xi", "lhs_maxQdiff", "bound"))
        for r in lemma), f"table_lemma2 rows {lemma}")
    print(f"harness table_memory: {len(on_card)} rows, states on the card, "
          f"rows equal the CPU's ({on_card[-1]['label']} gs_state_bytes "
          f"{on_card[-1]['gs_state_bytes']} at the reference's dtypes, "
          f"{on_card[-1]['gs_state_bytes_port']} held by the port); "
          f"table_lemma2: {len(lemma)} certificates hold, max lhs "
          f"{max(r['lhs_maxQdiff'] for r in lemma):.6e}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return counts


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


def device_summary(kept, match: str, top: int = 12) -> dict:
    """Means over the kept calls of ``traced_calls``: device busy share
    (the union of the call's kernel intervals over its host wall time),
    kernels, device ms, and the device ms of the kernels named ``match``;
    device time and launches by kernel name, largest first."""
    busy, per_kernel = [], {}
    for kernels, wall in kept:
        busy_us, reach = 0.0, float("-inf")
        for name, start, end in sorted(kernels, key=lambda k: k[1]):
            if end > reach:
                busy_us += end - max(start, reach)
                reach = end
            ms, n = per_kernel.get(name, (0.0, 0))
            per_kernel[name] = (ms + (end - start) / 1e3, n + 1)
        busy.append(busy_us / 1e6 / wall)
    calls = len(kept)
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_kernels": sum(len(k) for k, _ in kept) / calls,
            "device_busy_share": sum(busy) / calls,
            "wall_s": sum(w for _, w in kept) / calls,
            "device_ms": sum(ms for ms, _ in per_kernel.values()) / calls,
            "match_ms": sum(ms for name, (ms, _) in per_kernel.items()
                            if match in name) / calls,
            "top_kernels": [(name[:80], ms / calls, n / calls)
                            for name, (ms, n) in ranked]}


def profile_serving(run_prefill, run_serve_step):
    """Where the serving path's time goes: the prefill and
    PROFILE_DECODE_STEPS serve steps, each timed untraced and then
    traced as ``traced_calls`` takes them (the prefill's 42
    ``flash_fwd_sm90`` launches a call checked against the wrapper's
    count). Prints each window's wall seconds a call (their difference is
    the profiler's cost), the device busy share, the kernel launches, and
    device time by kernel name, means over the kept calls."""
    import torch

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
        summary = device_summary(
            traced_calls(fn, PROFILE_ITERS, "flash_fwd_sm90",
                         "flash_fwd_sm90"), "flash_fwd")
        print(f"profile {name} (mean of {PROFILE_ITERS} traced calls): "
              f"untraced {untraced:.4f} s, traced "
              f"{summary['wall_s']:.4f} s, device busy "
              f"{summary['device_busy_share']:.4f}, "
              f"{summary['device_kernels']:.0f} kernels, "
              f"{summary['device_ms']:.3f} ms of kernel time, flash "
              f"{summary['match_ms']:.3f} ms "
              f"({summary['match_ms'] / summary['device_ms']:.4f} of it)",
              flush=True)
        for kname, ms, n in summary["top_kernels"]:
            print(f"  {ms:10.3f} ms {n:6.0f}x  {kname}", flush=True)


def run_ssm_path(device):
    """``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
    (2, 8192, 1536) bf16 activations, against ``use_kernel=False``: the
    counted call (one launch of ``ssd_chunk_sm90``), then one untimed
    warm-up call of each and the median of SSM_TIMED synchronised calls of
    each, then the kernel call traced as ``traced_calls`` takes it (its
    one ``ssd_chunk_sm90`` launch a call checked against the wrapper's
    count) for the SSD kernel's share of the layer's device time.
    Returns the launch counts of the counted call."""
    import statistics
    import torch
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
        summary = device_summary(
            traced_calls(layer[True], PROFILE_ITERS, "ssd_chunk_sm90",
                         "ssd_chunk_sm90"), "ssd_chunk_sm90")
    check(counts["ssd_intra_chunk"] == 1 and counts["ssd_chunk_sm90"] == 1
          and counts["ssd_chunk"] == 0,
          f"ssm_layer launched the SSD kernels {counts['ssd_intra_chunk']} "
          f"times ({counts['ssd_chunk_sm90']} ssd_chunk_sm90, "
          f"{counts['ssd_chunk']} ssd_chunk), not ssd_chunk_sm90 once")
    check(tuple(y_k.shape) == (b, t, cfg.d_model) and y_k.dtype == cfg.dtype,
          f"ssm_layer output {tuple(y_k.shape)} {y_k.dtype}")
    err = allclose_err([("ssm_layer, kernel vs plain", y_k, y_p)],
                       SSM_LAYER_TOL)
    print(f"ssm layer: {cfg.num_heads} heads x {cfg.head_dim}, state "
          f"{cfg.state}, chunk {cfg.chunk}, on ({b}, {t}, {cfg.d_model}) "
          f"bf16: cold {cold_s:.4f} s; warm median of {SSM_TIMED} "
          f"{warm[True] * 1e3:.3f} ms with the kernel, "
          f"{warm[False] * 1e3:.3f} ms plain; traced (mean of "
          f"{PROFILE_ITERS} calls): {summary['device_kernels']:.0f} kernels, "
          f"{summary['device_ms']:.3f} ms of device time, ssd_chunk_sm90 "
          f"{summary['match_ms']:.4f} ms "
          f"({summary['match_ms'] / summary['device_ms']:.4f} of it); max abs "
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    if "--fault-worker" in argv:
        return fault_worker(argv)
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
        *one_shard, rank_counts = phase(
            "dials sharded path", run_sharded_path, device, smi, history,
            state)
        paths["dials sharded (1 shard, in process)"] = tuple(one_shard)
        paths[f"dials sharded ({SHARDED_RANKS} ranks)"] = (
            {k: sum(c.get(k, 0) for c in rank_counts)
             for k in rank_counts[0]}, {})
        paths["dials traffic"] = phase("dials traffic path",
                                       run_traffic_path, device)
        paths["envs"] = phase("envs on the card", run_envs_on_card, device)
        paths["checkpoint resume"] = phase(
            "checkpoint resume on the card", run_resume_path, device,
            (state, history))
        del state, history
        paths["dials async collect"] = phase(
            "dials async collect path", run_async_path, device, smi)
        paths["dials fault path (two ranks on cuda:0)"] = phase(
            "dials fault path", run_fault_path, device, smi)
        phase("dials small input vs plain", check_small_against_plain,
              device)
        paths["experiment harness (fig3 warehouse cell)"] = (phase(
            "experiment harness", run_harness_path, device), {})
        # the GAE forward at the harness's shape: T=16, B=N*E=4*8
        next(r for r in rows if r["name"] == "gae_forward")[
            "at_harness_shape"] = phase(
                "gae kernel vs plain at the harness shape",
                check_gae_forward_at, gen, device, 16, 4 * 8, ppo_cfg.gamma,
                ppo_cfg.lam)
        paths["contracts (walker, eager and capture calls; graph replays "
              "uncounted)"] = phase("contracts path", run_contracts_path,
                                    device, smi)
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
                                   "device_ms", "ms_by_route", "zamba2",
                                   "at_harness_shape")
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
