#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py
    python3 chip_smoke.py --only "lm architectures serving path"

(``--only`` runs the named phases of PHASES, comma-separated, and the
phases they read, after the build; its last line also names them.)

It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
     csrc``, prints the build seconds, and reads the built library with
     ``cuobjdump``: registers, stack, local memory and HGMMA (tensor-core)
     instructions of each flash kernel (the bf16 ones must have HGMMA), and
     registers, stack and local memory of each GRU kernel (those that keep
     W_h in registers must not spill), and the same with HGMMA for each
     instantiation of the bf16 SSD kernels ``ssd_chunk_sm90`` and
     ``ssd_chunk_sm90_long`` (each must have HGMMA) and of the float32
     long-chunk pair ``ssd_long_y``/``ssd_long_state`` (no spill);
  3. holds every kernel against its plain torch version on the card at
     the shapes its path gives it and times kernel, plain version and,
     where one exists, the one PyTorch call for the same function, with
     CUDA events: GRU (1e-5 times max(1, largest magnitude)) forward and
     backward at each of the forward's three FNN-policy path shapes, at
     the recurrent policy's (100x16x4, 100x1x16 and 100x1x8 at hidden
     128) and at 1x16x64 and 1x128x256 at hidden 128, the backward twice
     for its bits,
     times per launch and per step at each; the GRU above hidden 128 the
     same way at GRU_WIDE_SHAPES (100x7x128 at hidden 256, 16x16x64 at
     512: the forward on the cluster kernel ``gru_fwd_cluster``, twice for
     its bits, the backward's chain on the cluster chain
     ``gru_bwd_chain_cluster``, each plan printed) and at GRU_STREAM_SHAPE
     (hidden 640: ``gru_fwd_stream`` and ``gru_bwd_chain_stream``), each
     beside its bound and the plain version's time; GAE forward (bit for
     bit) and
     backward (1e-6), each with its device time per launch
     (``torch.profiler``) beside its host-inclusive time per call; flash
     attention at gemma2-9b's prefill
     shapes on bf16 inputs (the tensor-core kernel), against the plain
     version in float32 on the same inputs (1e-3 + 8e-3 |plain|), with its
     achieved TFLOP/s and share of the bf16 bound beside compiled
     ``flex_attention``, and one float32 shape (2e-5, the FFMA kernel); the
     kernels of the other head_dims (checked after the paths;
     FLASH_FFMA_CASES: 96 at T=4,096, 16 at the reduced gemma2-9b's layer,
     512; and FLASH_ODD_CASE, 36 in bf16): bf16 up to 256 on the
     tensor-core route ``flash_fwd_sm90_padded``, float32 on the FFMA
     kernel ``flash_fwd_padded``, and bf16 at 257..512 on the wide
     tensor-core route ``flash_fwd_sm90_wide`` (FLASH_WIDE_CASES: 512, 300
     and 384), each against the plain
     version in float32 (2e-5; 1e-3 + 8e-3 |plain|) with its time, bound,
     plain time and
     SDPA's for the causal case (null with a window or softcap: compiled
     ``flex_attention`` computes those, timed by
     ``benchmarks/torch_tree_times.py --library``); the
     SSD intra-chunk block and the SSD op at mamba2-780m's layer width, in
     float32 (2e-4, the FFMA kernel ``ssd_chunk``) and bf16 (the
     tensor-core kernel ``ssd_chunk_sm90`` and, as its "before",
     ``ssd_chunk`` on the same inputs), both bf16 routes timed, and at
     zamba2-1.2b's width (64 heads, state 64); the tiled pair
     ``ssd_chunk_tiled`` (any chunk, P, N) at chunk 256 with P = N = 6 in
     both dtypes (SSD_TILED_CASES), bf16 at chunk 256 on the tensor cores
     (``ssd_chunk_sm90_long``, at mamba2's and zamba2's widths:
     SSD_LONG_CASES) and float32 there on FFMA (``ssd_chunk_f32_long``:
     SSD_F32_LONG_CASES), each timed beside its bound and the plain
     version;
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
     3 timed ``train_fn`` steps and one ``eval_fn``, launching the GAE
     kernel); powergrid and supplychain, a 16-step GS trajectory each on
     the card and on the CPU, bit for bit, and one narrow-width round each;
     the recurrent-policy path again through a checkpoint: stopped after
     round 0, resumed by a new trainer for round 1, its record and state
     against the uninterrupted run (max abs differences printed); the
     recurrent-policy path with the overlapped GS collect: three rounds
     with ``async_collect=True`` (bound 2, telemetry on: the tags
     [0, 0, 1] and [True, False, False], the JSONL log valid,
     ``gru_forward`` launched by the collect worker on its own stream) and
     one at bound 0, bit for bit the record of the recurrent-policy
     path's serial run; then the
     sharded runtime's fault-tolerance half on the recurrent-policy path
     (``run_fault_path``, two ranks sharing cuda:0, re-invocations of
     this script as ``--fault-worker``): an uninterrupted run with
     distributed checkpoints (every step in the reference's per-slice
     layout; two rounds), step 1 restored onto one shard and run on
     (bit for bit the loop driver's flat restore), a host drop at round 1
     (the survivor's
     records and its final state bit for bit that one-shard resume, the
     event log through ``tools/telemetry_report_torch.py --check``), a recovery
     around the external coordinator under a chaos spec (the survivor
     re-executed as generation 1, bit for bit the same, within the
     two-rank tolerances of the uninterrupted run, ``--check
     --expect-recovery``) and the dispatch-mode async collect (bound 0
     bit for bit the serial run, bound 2 tags [0, 0, 1]), with the
     recovery times and the three kernels' launches printed; then the
     kernel path against the plain path on a small input (one round,
     warehouse side=2); the same small warehouse with the recurrent
     policy's GRU at hidden 512 and the AIP's at 256 (WIDE_GRU_HIDDEN: the
     cluster forward and the cluster chain, counted as the ``dials wide
     gru`` path), kernels against plain (AIP and policy params 1e-4)
     and every GRU and GAE kernel held to plain at each shape the round
     launched it; then the paper's experiment harness
     (``benchmarks/torch_run.py``): the ``fig3_learning`` cell of
     warehouse at the ``--fast`` widths, cut to 1 round of F=2 (DIALS,
     untrained-DIALS and GS
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
     synchronising calls of a steady round at F=1 and F=2 by source line,
     which must match, and no kernel build after round 0;
  5. drives the serving path of gemma2-9b at full width (bf16, random
     weights from a seed): the prefill step over a B=2 x T=8192 prompt
     with the flash kernel (42 launches, all of the bf16 kernel) and
     without it, their last
     logits compared, then a greedy decode of 16 tokens at B=4 after a
     32-token prompt; then profiles the prefill and 8 decode steps
     (device busy share, device time by kernel, flash's share), each
     traced over 4 calls after a warm-up, the last 2 kept, every kept
     call's traced flash launches equal to the wrapper's count (42 a
     prefill), or the phase fails; then the registry's other eight
     architectures (granite-moe, zamba2, mamba2 and whisper-tiny at full
     width and depth; dbrx, qwen1.5, yi and llama-3.2-vision at full
     width, cut in depth to fit the card) and gemma2-9b's reduced config
     (head_dim 16), bf16, each in turn: a B=2 x
     T=4096 prefill (whisper: 448 over 1,500 stub frames) with the flash
     kernel and without it, the last logits within LOGIT_TOL, each
     self-attention block launching once the kernel its head_dim routes to
     (``flash_fwd_sm90``; ``flash_fwd_sm90_padded`` at 16) and nothing
     else launched, the MoE's dropped share and aux terms; then a greedy
     decode at B=4, finite; init, prefill and decode times, parameter
     counts and peak memory printed;
  6. drives ``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
     (2, 8192, 1536) bf16 activations (one launch of ``ssd_chunk_sm90``)
     against ``use_kernel=False``, and at chunk 256 (one launch of
     ``ssd_chunk_sm90_long``) likewise, and in float32 at chunk 256 (one
     launch of ``ssd_chunk_f32_long``) likewise, then times the first both
     warm (median of 7) and
     profiles the kernel call the same way (the SSD kernel's share of its
     device time; one traced ``ssd_chunk_sm90`` launch a kept call);
  7. drives LM training on the card (``launch/steps.make_train_step``,
     bf16, ``remat="full"``, batches from ``data/pipeline.lm_iterator``
     on the card): tinyllama-1.1b at full width and depth, 2 steps of
     B=4 x T=4096 in 2 microbatches; one untimed and one timed step of
     granite-moe, mamba2, zamba2 and whisper-tiny at full width and depth
     (B=2 x T=1024; whisper 448 over 1,500 frames); two steps of each of
     llama-3.2-vision, dbrx, qwen1.5, yi and gemma2-9b at their reduced
     configs; each checked (losses and grad norms finite, grad norms
     above 0, the step-0 cross-entropy within 1 of ln V, ``opt["step"]``,
     the fp32 master moved, every leaf finite) with seconds a step,
     tokens/s and peak memory printed; then reduced tinyllama in float32
     on the card against the CPU (the gradients leaf by leaf, two steps)
     and microbatches 2 against 1 on the card, within 1e-4; no kernel
     launched (the flash kernel is forward-only, as the reference's);
  8. drives the LM mesh (``launch/steps``' mesh forms over
     ``distributed/mesh``'s rules): four gloo ranks share the card as a
     (data=2, model=2) DeviceMesh, tinyllama-1.1b at full width in bf16
     (depth cut to MESH_TRAIN_LAYERS and MESH_SERVE_LAYERS), their DTensor
     collectives staged through the host (``mesh.host_staged_collectives``):
     two train steps (TRAIN_RULES, FSDP over data, sequence parallel;
     the step-0 loss and grad norm against the single-device port's), a
     flash prefill (one ``flash_fwd_sm90`` launch a layer on every rank;
     logits against the single-device plain prefill), 8 decode steps
     with the distributed softmax and with ``decode_gathered`` (logits
     against the single device; each one step's collectives by kind,
     the softmax moving fewer bytes), the DIALS-outer sync over (pod=2,
     data=1, model=2) in fp32 and int8 (against the pod mean on one
     process) and a reduced float32 train step (1e-5), with each run's
     seconds and each rank's peak bytes; beside the ranks, one dry-run
     cell (``python -m repro_torch.launch.dryrun``) on a fake 256-rank
     group, its record's memory and collective totals printed;
  9. runs the port's bench gate and reports, no JAX
     (``run_bench_gate_path``): ``benchmarks/torch_kernels.py --fast``
     twice in process, ``benchmarks/torch_check_bench.py`` on the second
     record against the first (no structural finding; the time ratios
     printed, not gated) and on a copy with three planted defects (each
     found, nothing else), and ``benchmarks/torch_report.py``'s dry-run
     and roofline tables over 8's dry-run record, its roofline terms
     equal to ``benchmarks/torch_run.py --only roofline``'s;
 10. runs the port's scaling bench into its gate, no JAX
     (``run_scaling_gate_path``): ``benchmarks/torch_scaling.py --fast``
     once in process at traffic-2x2 (the ``-s1`` loop row, the ``-s2-p2``
     row on two gloo ranks sharing the card, the ``-streams8`` row),
     ``benchmarks/torch_check_bench.py --which scaling`` on its record
     against itself (no finding) and on a copy without one row (exactly
     that row missing), and each merged telemetry directory through
     ``tools/telemetry_report_torch.py --check``;
 11. prints the kernel table as one JSON line, the nvidia-smi line, and
     as its last line ``{"ok": true, "device": {...}}``.

Each path (each of 4's, 5's, 6, 7, 8, 9, 10) runs with every launch count set to 0
just before it and read just after (the kernels line gives each kernel's
launches by path); each phase prints its seconds, and a line before the
table all of them. Any failed phase
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
# the GRU above hidden 128 (the forward and the backward's chain on the
# cluster kernels): the paper's 100 agents at the AIP training's T=7 over
# 128 rows at 256, and a policy-like 512; and one small shape above the
# cluster's widest hidden, where both directions stream W_h
GRU_WIDE_SHAPES = ((100, 7, 128, 256), (16, 16, 64, 512))
GRU_STREAM_SHAPE = (2, 5, 8, 640)
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
# the FFMA flash kernel past the tensor-core kernel's head_dims (B, heads,
# KV heads, T, D, window, softcap): 96 at a full prompt, causal (the
# timed case, SDPA beside it); 16, the reduced gemma2-9b's layer at the
# lm serving path's prompt; 512, the widest, at T=2048. Each in float32
# (flash_fwd_padded) and, up to 256, in bf16 (flash_fwd_sm90_padded)
FLASH_FFMA_CASES = ((1, 8, 2, 4096, 96, None, None),
                    (2, 4, 2, 4096, 16, 32, 50.0),
                    (1, 4, 2, 2048, 512, 1024, 50.0))
# and one bf16 case of a head_dim that is no multiple of 8, whose rows the
# tensor-core route first copies into rows padded to 8
FLASH_ODD_CASE = (1, 8, 2, 2048, 36, 512, 50.0)
# flash_fwd_sm90_wide (bf16 at head_dim 257..512): FLASH_FFMA_CASES'
# widest (the timed case), 300 (rows padded to 304, DP 320) with a
# softcap only, and 384 at a window without a softcap, GQA and MHA
FLASH_WIDE_CASES = ((1, 4, 2, 2048, 512, 1024, 50.0),
                    (1, 8, 2, 2048, 300, None, 50.0),
                    (2, 4, 4, 1024, 384, 256, None))
# gemma2-9b last logits, flash against plain prefill, and the SSM layer's
# output, kernel against plain, both bf16: within tol times max(1, largest
# magnitude) (bf16 rounding flips at other places, carried through the
# stack)
LOGIT_TOL = 5e-2
SSM_LAYER_TOL = 2e-2

# The DIALS paths: side=10 (100 agents), the library's default widths,
# DIALSConfig() cut to a few rounds and F=2 (depth the run's time limit
# cannot pay for on a slow host). The first slice's path
# (warehouse, FNN policy) runs one round; the recurrent policy's path two,
# the second of which the checkpoint resume repeats; traffic one round and
# the GS baseline GS_TRAIN_STEPS steps; powergrid and supplychain an
# ENV_STEPS-step GS trajectory each, card against CPU.
SIDE = 10
AIP_REFRESH = 2
# the wide GRU path: the recurrent policy's GRU and the AIP's above 128
WIDE_GRU_HIDDEN = (512, 256)
FNN_ROUNDS = 1
GRU_POLICY_ROUNDS = 2
GS_TRAIN_STEPS = 3
ENV_STEPS = 16
# the overlapped collect on the recurrent-policy path: async (bound 2) and
# async at bound 0 (the serial schedule), against the serial run of
# run_gru_policy_path
ASYNC_ROUNDS = 3
ASYNC_ZERO_ROUNDS = 1
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
# restore of step FAULT_KILL_ROUND onto one shard, a host drop at the top
# of round FAULT_KILL_ROUND, a recovery under FAULT_CHAOS (rank 1's writer
# SIGKILLed once its slice of step FAULT_KILL_ROUND is prepared, its main
# thread parked in that round's heartbeat) and the overlapped collect at
# bound 0 (FAULT_ZERO_ROUNDS, held to that step of the uninterrupted run)
# and 2 (FAULT_ASYNC_ROUNDS). Each run holds two-rank rounds before the
# kill and solo rounds after it. The gate declares a silent rank dead
# after FAULT_BEAT_TIMEOUT_S; a collective with a stalled peer fails after
# the group's timeout FAULT_GRACE_S; a worker run is killed at
# FAULT_TIMEOUT_S.
FAULT_ROUNDS = 2
FAULT_KILL_ROUND = 1
FAULT_ZERO_ROUNDS = 1
FAULT_ASYNC_ROUNDS = 3
FAULT_BEAT_TIMEOUT_S = 15.0
FAULT_GRACE_S = 120.0
FAULT_TIMEOUT_S = 600
FAULT_CHAOS = (f"crash@{FAULT_KILL_ROUND}:host=1:phase=prepared,"
               f"delay@{FAULT_KILL_ROUND}:host=1:delay_s=120")

# The contracts phase (repro_torch.analysis): the recurrent-policy
# warehouse and the traffic paths at side=10, kernels on. Four programs
# each, with the CUDA-graph replays GraphCapturable runs (as many eager
# calls, a capture, as many replays, bit for bit); the round's
# synchronising calls at two values of F, the least that show a count
# growing with F. A capture the ring collect or the GS eval refuses is a
# finding (ROADMAP queue 3), not a failure; every other rule fails the run.
CONTRACT_PATHS = (("warehouse", "gru"), ("traffic", "fnn"))
CONTRACT_REPLAYS = {"ring_collect": 1, "aip_round": 1, "ials_train": 1,
                    "gs_eval": 1}
MAY_REFUSE_CAPTURE = ("ring_collect", "gs_eval")
SYNC_REFRESH = (1, 2)

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
# the tiled SSD kernels (any chunk, P, N): chunk 256 at mamba2-780m's
# layer width (B, T, heads, P, N, chunk, dtype) with P = N = 6 in both
# dtypes (P 64 at N 64 or 128 and chunk 256 goes to the long routes)
SSD_TILED_CASES = ((2, 8192, 48, 6, 6, 256, "float32"),
                   (2, 8192, 48, 6, 6, 256, "bfloat16"))
# ssd_chunk_sm90_long (bf16, P 64, chunk 256): mamba2-780m's layer width
# (N 128) and zamba2-1.2b's (64 heads, N 64)
SSD_LONG_CASES = ((2, 8192, 48, 64, 128, 256, "bfloat16"),
                  (2, 8192, 64, 64, 64, 256, "bfloat16"))
# ssd_chunk_f32_long (float32, P 64, chunk 256): the same two widths
SSD_F32_LONG_CASES = ((2, 8192, 48, 64, 128, 256, "float32"),
                      (2, 8192, 64, 64, 64, 256, "float32"))
SSM_TILED_CHUNK = 256
SSM_TIMED = 7

# The registry's other eight architectures served (their reference
# configs, src/repro/configs/): bf16, weights drawn on the card from a
# seed, full width. granite-moe, zamba2, mamba2 and whisper at full depth;
# the four whose weights one 80 GB card cannot hold cut to LM_DEPTH_CUT
# layers (llama-vision: one period of four self + one cross block).
# Prefill B=2 x T=4096 (whisper's decoder: its target length 448, over
# the stub encoder's 1,500 frames) with the flash kernel and without;
# greedy decode of LM_DECODE_NEW tokens at B=4 after LM_DECODE_PROMPT.
LM_ARCHS = ("granite-moe-1b-a400m", "zamba2-1.2b", "mamba2-780m",
            "whisper-tiny", "dbrx-132b", "qwen1.5-32b", "yi-34b",
            "llama-3.2-vision-90b")
LM_DEPTH_CUT = {"dbrx-132b": 2, "qwen1.5-32b": 8, "yi-34b": 8,
                "llama-3.2-vision-90b": 5}
# flash launches a prefill: one a self-attention block (zamba2: one a
# shared application, 19; whisper: its decoder's 4, none in the encoder;
# llama-vision: 4 a period; mamba2 none)
LM_FLASH_LAUNCHES = {"granite-moe-1b-a400m": 24, "zamba2-1.2b": 19,
                     "mamba2-780m": 0, "whisper-tiny": 4, "dbrx-132b": 2,
                     "qwen1.5-32b": 8, "yi-34b": 8,
                     "llama-3.2-vision-90b": 4, "gemma2-9b-reduced": 2}
# reduced configs served beside them: gemma2-9b's (2 layers, head_dim 16,
# bf16), whose attention takes the padded tensor-core route
LM_REDUCED = ("gemma2-9b",)
LM_PROMPT = (2, 4096)
WHISPER_TARGET = 448
LM_DECODE_BATCH, LM_DECODE_PROMPT, LM_DECODE_NEW = 4, 8, 8

# LM training (launch/steps.make_train_step, bf16, remat "full", batches
# from data/pipeline.lm_iterator on the card): tinyllama-1.1b at full width
# and depth (src/repro/configs/tinyllama_1_1b.py:16) at train_4k's seq
# 4,096 with the global batch cut from 256 to 4 (8 before PR 24), in
# LM_TRAIN_MICROBATCHES slices, LM_TRAIN_STEPS steps (the first untimed);
# one untimed and one
# timed step of each of LM_TRAIN_FAMILIES at full width and depth, B=2 x
# T=1024 (whisper: its 448-token target over 1,500 frames of
# synthetic.frames); two steps of each of LM_TRAIN_REDUCED at its reduced
# config (their AdamW state does not fit one card at full width; their
# mesh layouts are dry-run: launch/dryrun.py); reduced tinyllama in
# float32, two steps
# on the card against the CPU and microbatches 2 against 1 on the card,
# within LM_TRAIN_TOL (relative; of each leaf's largest magnitude). A
# train step launches none of the six kernels: the reference's flash
# kernel is forward-only and its SSM blocks run the plain scan.
LM_TRAIN_ARCH = "tinyllama-1.1b"
LM_TRAIN_SHAPE = (4, 4096)
LM_TRAIN_MICROBATCHES = 2
LM_TRAIN_STEPS = 2
LM_TRAIN_FAMILIES = ("granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b",
                     "whisper-tiny")
LM_TRAIN_FAMILY_SHAPE = (2, 1024)
LM_TRAIN_REDUCED = ("llama-3.2-vision-90b", "dbrx-132b", "qwen1.5-32b",
                    "yi-34b", "gemma2-9b")
LM_TRAIN_TOL = 1e-4
# its name in the kernels line's launches by path, where its zeros show
LM_TRAIN_PATH = "lm training (forward-only flash, plain SSM scan)"

# The LM mesh (launch/steps' mesh forms over distributed/mesh's rules):
# MESH_RANKS gloo ranks sharing cuda:0 as a (data=2, model=2) DeviceMesh,
# tinyllama-1.1b at full width in bf16, random weights from one seed on
# every rank, the depth cut to fit the phase's 90 s (MESH_TRAIN_LAYERS,
# MESH_SERVE_LAYERS of 22). Train: TRAIN_RULES, FSDP over data, sequence
# parallel, MESH_TRAIN_STEPS steps at MESH_TRAIN_SHAPE (the step-0 loss
# and grad norm against the single-device port's at the same weights and
# batch, within MESH_TOL); prefill at MESH_PREFILL with use_flash=True
# (flash_fwd_sm90 launched once a self-attention layer on every rank;
# last logits against the single-device plain prefill);
# decode of MESH_DECODE_STEPS tokens (teacher-forced, the same tokens on
# both sides) against a MESH_DECODE_SLOTS-slot cache whose sequence axis
# is over model, with the distributed softmax and with decode_gathered;
# one DIALS-outer sync over (pod=2, data=1, model=2), fp32 and int8,
# against the pod mean on one process; reduced tinyllama in float32,
# one mesh train step against the single device within MESH_F32_TOL; and
# one dry-run cell as a subprocess on a fake 256-rank group.
MESH_RANKS = 4
MESH_SHAPE = (2, 2)
MESH_TRAIN_SHAPE = (4, 1024)
MESH_TRAIN_STEPS = 2
MESH_TRAIN_LAYERS = 2
MESH_SERVE_LAYERS = 4
MESH_PREFILL = (4, 4096)
MESH_DECODE_SLOTS, MESH_DECODE_STEPS = 4096, 8
# bf16 mesh against one device, relative to max(1, |single-device value|):
# the split products sum bf16 partials across ranks in another order
MESH_TOL = {"loss": 1e-2, "grad_norm": 5e-2, "logits": LOGIT_TOL}
MESH_F32_TOL = 1e-5
MESH_OUTER_TOL = 1e-6
MESH_TIMEOUT_S = 600
MESH_DRYRUN = ("tinyllama-1.1b", "train_4k", "single")


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
PROFILE_ITERS = 2


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


def check_gru_wide(gen, device):
    """The GRU above hidden 128: at GRU_WIDE_SHAPES the forward on the
    cluster kernel (``gru_fwd_cluster``) and the backward's chain on the
    cluster chain (``gru_bwd_chain_cluster``), each plan and the clusters
    the card holds of it at once printed; at GRU_STREAM_SHAPE (above the
    cluster's widest hidden) both streaming (``gru_fwd_stream``,
    ``gru_bwd_chain_stream``); each held to the plain version forward and
    backward (GRU_TOL), the backward twice for its bits and the cluster
    forward twice, and timed with CUDA events beside its bound and the
    plain version's time. Returns the kernel rows of the cluster forward
    and the cluster backward, timed at the first wide shape, and of the
    streaming forward and backward at GRU_STREAM_SHAPE."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.gru import kernel as gk, ref as gref
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ext = build.extension()
    max_active = {"forward": ext.gru_forward_cluster_max_active,
                  "backward": ext.gru_backward_cluster_max_active}
    errs = {"cluster": 0.0, "stream": 0.0, "bwd_cluster": 0.0,
            "bwd_stream": 0.0}
    timed = {}
    for a, t, b, hdim in GRU_WIDE_SHAPES + (GRU_STREAM_SHAPE,):
        shape = (a, t, b, hdim)
        kind = gk.forward_route(shape, sms, max_active["forward"])
        bwd = gk.backward_route(shape, sms, max_active["backward"])
        want = "stream" if shape == GRU_STREAM_SHAPE else "cluster"
        check(kind == want and bwd == want,
              f"gru {a}x{t}x{b}x{hdim}: forward route {kind}, backward "
              f"route {bwd}, want {want}")
        fe, be, ins, g = gru_case(gen, device, a, t, b, hdim)
        errs[kind] = max(errs[kind], fe)
        errs[f"bwd_{bwd}"] = max(errs[f"bwd_{bwd}"], be)
        hs = gk.forward(*ins)
        plan = ""
        if kind == "cluster":
            for direction in ("forward", "backward"):
                ctas, rows = gk.cluster_plan(hdim, b, a, sms, direction)
                active = max_active[direction](hdim, ctas, rows)
                check(active >= 1, f"gru {direction} cluster {ctas} CTAs x "
                                   f"{rows} rows at hidden {hdim}: the card "
                                   f"holds {active}")
                smem = (gk.cluster_smem_bytes(hdim, rows)
                        if direction == "forward" else
                        gk.cluster_chain_smem_bytes(hdim, ctas, rows))
                plan += (f" [{direction}: cluster of {ctas} CTAs x {rows} "
                         f"rows, {smem} B of shared memory a CTA, {active} "
                         f"clusters at once]")
            check(torch.equal(hs, gk.forward(*ins)),
                  f"gru_fwd_cluster {a}x{t}x{b}x{hdim}: two calls differ in "
                  f"their bits")
            plan += " both bitwise repeatable"
        leaves = [x.clone().requires_grad_() for x in ins[:4]]
        hs_p = gref.gru_scan(*leaves, ins[4])
        fb, bb = gru_bounds(a, t, b, hdim)
        timed[shape] = x = dict(
            ms=cuda_ms(lambda: gk.forward(*ins), 10),
            bwd_ms=cuda_ms(lambda: gk.backward(*ins, hs, g), 10),
            plain_ms=cuda_ms(lambda: gref.gru_scan(*ins), 3),
            plain_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                hs_p, leaves, g, retain_graph=True), 3),
            bound=fb, bwd_bound=bb)
        print(f"gru {a}x{t}x{b}x{hdim}: forward ({kind}) {x['ms']:.4f} ms "
              f"(bound {fb[0]:.5f} ms by {fb[1]}, {fb[0] / x['ms']:.4f} "
              f"of it; plain {x['plain_ms']:.4f} ms); backward ({bwd}) "
              f"{x['bwd_ms']:.4f} ms (bound {bb[0]:.5f} ms by {bb[1]}, "
              f"{bb[0] / x['bwd_ms']:.4f} of it; plain "
              f"{x['plain_bwd_ms']:.4f} ms){plan}", flush=True)
        del hs, hs_p, leaves
        torch.cuda.empty_cache()
    wide = {k: v for k, v in timed.items() if k != GRU_STREAM_SHAPE}
    key = GRU_WIDE_SHAPES[0]
    by_shape = lambda f: {"x".join(map(str, k)): f(v)
                          for k, v in wide.items()}
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/gru.cu",
                  library_ms=None)
    first, small = timed[key], timed[GRU_STREAM_SHAPE]
    return [
        dict(name="gru_forward_cluster",
             replaces="src/repro/kernels/gru/kernel.py:64",
             max_abs_err=errs["cluster"], ms=first["ms"],
             plain_ms=first["plain_ms"], bound=first["bound"],
             shape="x".join(map(str, key)),
             ms_by_shape=by_shape(lambda v: v["ms"]),
             bound_ms_by_shape=by_shape(lambda v: v["bound"][0]),
             plain_ms_by_shape=by_shape(lambda v: v["plain_ms"]), **common),
        dict(name="gru_backward_cluster",
             replaces="src/repro/kernels/gru/kernel.py:132",
             max_abs_err=errs["bwd_cluster"], ms=first["bwd_ms"],
             plain_ms=first["plain_bwd_ms"], bound=first["bwd_bound"],
             shape="x".join(map(str, key)),
             ms_by_shape=by_shape(lambda v: v["bwd_ms"]),
             bound_ms_by_shape=by_shape(lambda v: v["bwd_bound"][0]),
             plain_ms_by_shape=by_shape(lambda v: v["plain_bwd_ms"]),
             **common),
        dict(name="gru_forward_stream",
             replaces="src/repro/kernels/gru/kernel.py:64",
             max_abs_err=errs["stream"], ms=small["ms"],
             plain_ms=small["plain_ms"], bound=small["bound"],
             shape="x".join(map(str, GRU_STREAM_SHAPE)), **common),
        dict(name="gru_backward_stream",
             replaces="src/repro/kernels/gru/kernel.py:132",
             max_abs_err=errs["bwd_stream"], ms=small["bwd_ms"],
             plain_ms=small["plain_bwd_ms"], bound=small["bwd_bound"],
             shape="x".join(map(str, GRU_STREAM_SHAPE)), **common),
    ]


def gae_case(gen, device, t, b, gamma, lam):
    """Both GAE kernels against the plain version at (T, B): the forward
    bit for bit, the gradients at GAE_TOL. Returns (forward error,
    gradient error, inputs, cotangent, the plain advantages and leaves
    kept for a timed backward)."""
    import torch
    from repro_torch.kernels.gae import kernel as ak, ref as aref
    r, v, nv = (torch.randn(t, b, generator=gen, device=device)
                for _ in range(3))
    d = (torch.rand(t, b, generator=gen, device=device) < 0.05).float()
    g = torch.randn(t, b, generator=gen, device=device)
    kw = dict(gamma=gamma, lam=lam)
    adv_k = ak.forward(r, v, nv, d, gamma, lam)
    adv_p = aref.gae_reverse_scan(r, v, nv, d, **kw)
    check(torch.equal(adv_k, adv_p), f"gae_forward {t}x{b}: not bit for bit "
                                     f"equal to the plain version")
    fwd_err = max_err(adv_k, adv_p)
    leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    grads_k = torch.autograd.grad(
        ak.GAEScan.apply(*leaves, d, gamma, lam), leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    adv_p = aref.gae_reverse_scan(*ref_leaves, d, **kw)
    grads_p = torch.autograd.grad(adv_p, ref_leaves, g, retain_graph=True)
    bwd_err = allclose_err(
        [(f"gae_backward {t}x{b} d{n}", k, p) for n, k, p in
         zip(("rewards", "values", "next_values"), grads_k, grads_p)],
        GAE_TOL)
    return fwd_err, bwd_err, (r, v, nv, d), g, adv_p, ref_leaves


def check_gae(gen, device, t, b, gamma, lam):
    import torch
    from repro_torch.kernels.gae import kernel as ak, ref as aref
    fwd_err, bwd_err, (r, v, nv, d), g, adv_p, ref_leaves = gae_case(
        gen, device, t, b, gamma, lam)
    kw = dict(gamma=gamma, lam=lam)
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


def check_flash_at_lm_shapes(gen, device):
    """The tensor-core flash kernel at the shapes the ``lm architectures
    serving path`` gives it (one per architecture with self-attention:
    B=2 rows of LM_PROMPT, whisper's decoder at WHISPER_TARGET; causal, no
    window or softcap), bf16, q scaled by FLASH_Q_SCALE, held to the plain
    version in float32 on the same inputs (FLASH_TOL); kernel, plain and
    ``scaled_dot_product_attention`` (causal, GQA: the same function here)
    times with CUDA events, and the bound. Returns {arch: numbers}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    from repro_torch.launch import steps
    out = {}
    for arch in LM_ARCHS:
        cfg = steps.model_cfg(registry.get(arch))
        attn = next((ls.attn for ls in cfg.period + (cfg.shared,)
                     if ls is not None and ls.mixer == "attn"), None)
        if attn is None:
            continue
        b, t = LM_PROMPT
        if arch == "whisper-tiny":
            t = WHISPER_TARGET
        h, hkv, d = attn.num_heads, attn.num_kv_heads, attn.dh
        rnd = lambda n: torch.randn(b * n, t, d, generator=gen,
                                    device=device).bfloat16()
        q, k, v = rnd(h) * FLASH_Q_SCALE, rnd(hkv), rnd(hkv)
        got = launched(fk.LAUNCHES, "flash_fwd_sm90",
                       lambda: fk.forward(q, k, v, causal=True))
        want = torch.cat([fr.attention_bhsd(
            q[i * h:(i + 1) * h].float(), k[i * hkv:(i + 1) * hkv].float(),
            v[i * hkv:(i + 1) * hkv].float(), causal=True)
            for i in range(b)])
        err = allclose_rel(f"flash bf16 at {arch}'s shape", got, want,
                           *FLASH_TOL["bfloat16"])
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fk.forward(q, k, v, causal=True), 5)
        plain_ms = cuda_ms(lambda: torch.cat([fr.attention_bhsd(
            q[i * h:(i + 1) * h], k[i * hkv:(i + 1) * hkv],
            v[i * hkv:(i + 1) * hkv], causal=True) for i in range(b)]), 1)
        qb, kb, vb = (x.view(b, -1, t, d) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True, enable_gqa=True), 5)
        flop = 4.0 * d * b * h * live_pairs(t, None)
        nbytes = 2.0 * (2 * b * h * t * d + 2 * b * hkv * t * d)
        bound = bound_ms(nbytes, flop, PEAK_BF16_PER_S)
        out[arch] = {"shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms,
                     "library": "scaled_dot_product_attention (causal, GQA)"}
        print(f"flash bf16 at {arch}'s prefill shape q {tuple(q.shape)}, "
              f"k/v {tuple(k.shape)}: {ms:.4f} ms ({flop / ms / 1e9:.2f} "
              f"TFLOP/s, {bound[0] / ms:.4f} of the bound {bound[0]:.4f} ms "
              f"by {bound[1]}), plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms; max abs err {err:.3e}", flush=True)
        del q, k, v, qb, kb, vb
        torch.cuda.empty_cache()
    return out


FLASH_SOURCES = {
    "flash_fwd_sm90_padded":
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
    "flash_fwd_padded": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_fwd_sm90_wide":
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"}


def flash_route_of(dtype, d: int) -> str:
    """The route each head_dim outside 64/128/256 must take: float32 on
    the FFMA kernel, bf16 on the tensor cores, padded up to 256 and wide
    above."""
    import torch
    if dtype == torch.float32:
        return "flash_fwd_padded"
    return "flash_fwd_sm90_padded" if d <= 256 else "flash_fwd_sm90_wide"


def check_flash_ffma(gen, device):
    """Flash attention at the head_dims outside 64/128/256
    (FLASH_FFMA_CASES: 96 at T=4,096; 16, the reduced configs'; 512, the
    widest, each in float32 and, up to 256, in bf16; and FLASH_ODD_CASE in
    bf16): bf16 on the tensor-core route ``flash_fwd_sm90_padded``,
    float32 on the FFMA kernel ``flash_fwd_padded``; see
    :func:`check_flash_cases`. Returns the two kernel rows."""
    import torch
    cases = [(c, dt) for c in FLASH_FFMA_CASES
             for dt in (torch.bfloat16, torch.float32)
             if dt == torch.float32 or c[4] <= 256]
    cases.append((FLASH_ODD_CASE, torch.bfloat16))
    return check_flash_cases(gen, device, cases)


def check_flash_wide(gen, device):
    """``flash_fwd_sm90_wide`` (bf16 at head_dim 257..512) at
    FLASH_WIDE_CASES; see :func:`check_flash_cases`. Returns its row."""
    import torch
    return check_flash_cases(gen, device, [(c, torch.bfloat16)
                                           for c in FLASH_WIDE_CASES])[0]


def check_flash_cases(gen, device, cases):
    """Each (case, dtype) of ``cases`` on the route ``route`` names (held
    to :func:`flash_route_of`), against the plain version in float32 on
    the same inputs (FLASH_TOL; bf16 q scaled by FLASH_Q_SCALE), timed
    with CUDA events beside its bound (the true head_dim's FLOPs over the
    peak of the inputs' type) and the plain version; beside each,
    ``scaled_dot_product_attention`` for the causal case, and null where a
    window or softcap is set (compiled ``flex_attention`` computes those:
    ``benchmarks/torch_tree_times.py --library`` times it). Returns a row
    a kernel, each timed at its first case, with the launches this check
    made (``kernel_phase_launches``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk, ref as fr
    before = dict(fk.LAUNCHES)
    by_kernel = {}
    for (b, h, hkv, t, d, window, cap), dtype in cases:
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        name = str(dtype).replace("torch.", "")
        rnd = lambda n: torch.randn(b * n, t, d, generator=gen,
                                    device=device)
        q, k, v = rnd(h), rnd(hkv), rnd(hkv)
        if dtype == torch.bfloat16:
            q = q * FLASH_Q_SCALE
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        kernel, want_kernel = fk.route(dtype, d), flash_route_of(dtype, d)
        check(kernel == want_kernel,
              f"flash {name} D={d} routes to {kernel}, not {want_kernel}")
        got = launched(fk.LAUNCHES, kernel,
                       lambda: fk.forward(q, k, v, **kw))
        want = torch.cat([fr.attention_bhsd(
            q[i * h:(i + 1) * h].float(),
            k[i * hkv:(i + 1) * hkv].float(),
            v[i * hkv:(i + 1) * hkv].float(), **kw) for i in range(b)])
        label = f"{kernel} {name} {b}x{h}/{hkv}x{t}xD{d}"
        err = allclose_rel(label, got, want, *FLASH_TOL[name])
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fk.forward(q, k, v, **kw), 5)
        plain_ms = cuda_ms(lambda: torch.cat([fr.attention_bhsd(
            q[i * h:(i + 1) * h], k[i * hkv:(i + 1) * hkv],
            v[i * hkv:(i + 1) * hkv], **kw) for i in range(b)]), 2)
        if window is None and cap is None:
            qb, kb, vb = (x.view(b, -1, t, d) for x in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True, enable_gqa=True), 5)
            lib_name = "scaled_dot_product_attention (causal, GQA)"
        else:
            lib_ms, lib_name = None, (
                "compiled flex_attention computes it; timed by "
                "benchmarks/torch_tree_times.py --library")
        flop = 4.0 * d * b * h * live_pairs(t, window)
        nbytes = q.element_size() * (2 * b * h * t * d
                                     + 2 * b * hkv * t * d)
        bound = bound_ms(nbytes, flop, PEAK_BF16_PER_S
                         if dtype == torch.bfloat16 else PEAK_FP32_PER_S)
        by_kernel.setdefault(kernel, {})[label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library=lib_name,
            bound_ms=bound[0], bound_by=bound[1], max_abs_err=err,
            bound=bound)
        print(f"{label} (window {window}, softcap {cap}): {ms:.4f} ms, "
              f"{flop / ms / 1e9:.2f} TFLOP/s, {bound[0] / ms:.4f} of "
              f"the bound {bound[0]:.5f} ms by {bound[1]}; plain "
              f"{plain_ms:.4f} ms; {lib_name}"
              + (f": {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f"; max abs err {err:.3e}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    rows = []
    for kernel, timed in by_kernel.items():
        first = next(iter(timed))
        row = timed[first]
        rows.append(dict(
            name=kernel, route="cuda", source=FLASH_SOURCES[kernel],
            replaces="src/repro/kernels/flash_attention/kernel.py:95",
            max_abs_err=max(x["max_abs_err"] for x in timed.values()),
            ms=row["ms"], plain_ms=row["plain_ms"], bound=row["bound"],
            library_ms=row["library_ms"], library=row["library"],
            shape=first, kernel_phase_launches=fk.LAUNCHES[kernel]
            - before[kernel],
            by_shape={k: {n: x for n, x in v.items() if n != "bound"}
                      for k, v in timed.items()}))
    return rows


def flash_library_ms(q, k, v, b, cases):
    """One PyTorch call for the same function, timed as a yardstick only:
    ``flex_attention`` (compiled) with a softcap ``score_mod`` (the
    cases' one softcap, or none) and a causal+window ``mask_mod``, one
    call a case. Returns (ms a launch, the mean over the cases, and its
    name), or (None, the reason) if it does not run here: no other call
    computes this function (SDPA has no softcap), so none stands in for
    it."""
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
                qb, kb, vb, score_mod=None if cap is None else score_mod,
                block_mask=m, enable_gqa=True))
        return cuda_ms(lambda: [c() for c in calls], 3) / len(calls), name
    except Exception as exc:     # a yardstick: the port never calls it
        reason = (f"{name} did not run ({type(exc).__name__}: "
                  f"{str(exc)[:200]}); library_ms is null")
        print(reason, flush=True)
        return None, reason


def kernel_resources():
    """Registers, stack and local memory (``cuobjdump -res-usage``) of
    each flash and GRU kernel in the built library, dynamic shared memory,
    and HGMMA instructions (``cuobjdump -sass``) of each flash kernel.
    Fails unless every instantiation of the bf16 flash kernels
    (``flash_fwd_sm90`` at 64/128/256, ``flash_fwd_sm90_padded`` at
    64/128/192/256, ``flash_fwd_sm90_wide`` at 320/384/448/512, which
    must also not spill and use the shared memory the wrapper reckons)
    issues HGMMA, if the FFMA kernel has a bf16 instantiation, and if a
    GRU kernel that keeps W_h in
    registers, or the cluster forward, spills to local memory (a stack
    frame or local bytes)."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(build.LIBRARY)
    from concurrent.futures import ThreadPoolExecutor
    run = lambda flag: subprocess.run([tool, flag, lib], capture_output=True,
                                      text=True, timeout=300,
                                      check=True).stdout
    with ThreadPoolExecutor(2) as pool:   # the two dumps side by side
        res_usage, sass = pool.map(run, ("-res-usage", "-sass"))
    # flash_fwd_sm90<D>, flash_fwd_sm90_padded<DP> and flash_fwd<DC, RQ,
    # CK, T, PADDED> (D = 64 DC): the route flash_fwd without PADDED,
    # flash_fwd_padded with it; and the padded route's row copy
    flash = re.compile(r"(flash_fwd_sm90(?:_padded|_wide)?)ILi(\d+)EE|"
                       r"flash_fwdILi(\d+)ELi(\d+)ELi\d+E"
                       r"(f|13__nv_bfloat16)Lb([01])E|(flash_pad_rows)E")

    def flash_key(m):
        if m.group(7):
            return ("flash_pad_rows", 0, "bf16", "")
        if m.group(1):
            return (m.group(1), int(m.group(2)), "bf16", "")
        if m.group(6) == "0":
            return ("flash_fwd", 64 * int(m.group(3)), "f32", "")
        return ("flash_fwd_padded", 64 * int(m.group(3)),
                "f32" if m.group(5) == "f" else "bf16",
                f"rows {16 * int(m.group(4))}")
    usage, fn = {}, None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = flash.search(m.group(1))
        elif fn and "REG:" in line:
            usage[flash_key(fn)] = dict(re.findall(r"(\w+):(\d+)", line))
            fn = None
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = flash.search(m.group(1))
        elif fn and "HGMMA" in line:
            key = flash_key(fn)
            hgmma[key] = hgmma.get(key, 0) + 1
    ext = build.extension()
    for key, use in sorted(usage.items()):
        name, d, dtype, tiles = key
        smem = ext.flash_attention_sm90_smem_bytes(d) \
            if name.startswith("flash_fwd_sm90") else None
        print(f"resources {name} D={d} {dtype}{' ' + tiles if tiles else ''}"
              f": REG {use.get('REG')} (at entry), "
              f"STACK {use.get('STACK')}, LOCAL {use.get('LOCAL')}, static "
              f"SHARED {use.get('SHARED')}, dynamic shared "
              f"{smem if smem is not None else 'see flash_attention.cu'}, "
              f"HGMMA {hgmma.get(key, 0)}", flush=True)
    for d in (64, 128, 256):
        key = ("flash_fwd_sm90", d, "bf16", "")
        check(key in usage, f"flash_fwd_sm90 D={d} not found in {lib}")
        check(hgmma.get(key, 0) > 0,
              f"flash_fwd_sm90 D={d} issues no HGMMA: not on the tensor "
              f"cores")
    for d in (64, 128, 192, 256):
        key = ("flash_fwd_sm90_padded", d, "bf16", "")
        check(key in usage, f"flash_fwd_sm90_padded DP={d} not found in "
                            f"{lib}")
        check(hgmma.get(key, 0) > 0,
              f"flash_fwd_sm90_padded DP={d} issues no HGMMA: not on the "
              f"tensor cores")
    from repro_torch.kernels.flash_attention import kernel as fk
    for d in (320, 384, 448, 512):
        key = ("flash_fwd_sm90_wide", d, "bf16", "")
        check(key in usage, f"flash_fwd_sm90_wide DP={d} not found in {lib}")
        check(hgmma.get(key, 0) > 0,
              f"flash_fwd_sm90_wide DP={d} issues no HGMMA: not on the "
              f"tensor cores")
        check(usage[key].get("STACK") == "0" and
              usage[key].get("LOCAL") == "0",
              f"flash_fwd_sm90_wide DP={d} spills to local memory")
        check(ext.flash_attention_sm90_smem_bytes(d) == fk.wide_smem_bytes(d)
              <= fk.MAX_SMEM_BYTES,
              f"flash_fwd_sm90_wide DP={d}: shared memory "
              f"{ext.flash_attention_sm90_smem_bytes(d)}, the wrapper "
              f"reckons {fk.wide_smem_bytes(d)}")
    check(("flash_pad_rows", 0, "bf16", "") in usage,
          f"flash_pad_rows not found in {lib}")
    for d in (64, 128, 256):
        check(("flash_fwd", d, "f32", "") in usage,
              f"flash_fwd D={d} not found in {lib}")
    for d in (64, 128, 192, 256, 384, 512):
        for dtype in ("f32", "bf16"):
            # bf16 runs on the tensor cores, and only there
            built = any(k[:3] == ("flash_fwd_padded", d, dtype)
                        for k in usage)
            check(built == (dtype == "f32"),
                  f"flash_fwd_padded D={d} {dtype} "
                  f"{'not found' if not built else 'built'} in {lib}")
    ssd_resources(res_usage, sass, ext)
    gru_resources(res_usage, ext)


def ssd_resources(res_usage: str, sass: str, ext):
    """Registers, stack, local memory, dynamic shared memory and HGMMA
    count of each instantiation (chunk L, state N) of ``ssd_chunk_sm90``
    and of ``ssd_chunk_sm90_long`` (L 256); fails unless all six are built
    and every one issues HGMMA. Then the float32 long-chunk pair
    (``ssd_long_y``, ``ssd_long_state``), which must not spill."""
    import re
    pat = re.compile(r"ssd_chunk_sm90ILi(\d+)ELi(\d+)E|"
                     r"ssd_chunk_sm90_longILi(\d+)E")
    key = lambda m: (("ssd_chunk_sm90", m.group(1), m.group(2))
                     if m.group(1) else
                     ("ssd_chunk_sm90_long", "256", m.group(3)))
    usage, hgmma, fn, found_long = {}, {}, None, set()
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = pat.search(m.group(1))
        elif fn and "REG:" in line:
            usage[key(fn)] = dict(re.findall(r"(\w+):(\d+)", line))
            fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = pat.search(m.group(1))
        elif fn and "HGMMA" in line:
            hgmma[key(fn)] = hgmma.get(key(fn), 0) + 1
    smem = {"ssd_chunk_sm90": ext.ssd_sm90_smem_bytes,
            "ssd_chunk_sm90_long": ext.ssd_sm90_long_smem_bytes}
    for (name, lc, nc), use in sorted(usage.items()):
        print(f"resources {name} L={lc} N={nc}: REG {use.get('REG')}"
              f" (at entry), STACK {use.get('STACK')}, LOCAL "
              f"{use.get('LOCAL')}, dynamic shared "
              f"{smem[name](int(lc), 64, int(nc))}, HGMMA "
              f"{hgmma.get((name, lc, nc), 0)}", flush=True)
    for name, lc, nc in [("ssd_chunk_sm90", lc, nc) for lc in ("64", "128")
                         for nc in ("64", "128")] + [
            ("ssd_chunk_sm90_long", "256", nc) for nc in ("64", "128")]:
        check((name, lc, nc) in usage,
              f"{name} L={lc} N={nc} not in the library")
        check(hgmma.get((name, lc, nc), 0) > 0,
              f"{name} L={lc} N={nc} issues no HGMMA")
    # the float32 long-chunk pair (FFMA): registers, and no spill
    fn = None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = re.search(r"(ssd_long_y|ssd_long_state)E", m.group(1))
        elif fn and "REG:" in line:
            use = dict(re.findall(r"(\w+):(\d+)", line))
            name, fn = fn.group(1), None
            print(f"resources {name}: REG {use.get('REG')}, STACK "
                  f"{use.get('STACK')}, LOCAL {use.get('LOCAL')}, dynamic "
                  f"shared {ext.ssd_f32_long_smem_bytes(128)} bytes (the "
                  f"pair's larger at N 128)", flush=True)
            check(use.get("STACK") == "0" and use.get("LOCAL") == "0",
                  f"{name} spills to local memory")
            found_long.add(name)
    check(found_long == {"ssd_long_y", "ssd_long_state"},
          f"the float32 long-chunk pair in the library: {found_long}")


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
                       r"gru_bwd_gates)E|(gru_fwd_stream|gru_bwd_chain_stream"
                       r"|gru_fwd_cluster)ILi(\d+)E")
    chain = re.compile(r"gru_bwd_chain_clusterILi(\d+)ELi(\d+)E")
    found, fn = [], None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = (recur.search(m.group(1)) or plain.search(m.group(1))
                  or chain.search(m.group(1)))
        elif fn and "REG:" in line:
            groups = fn.groups()
            if fn.re is plain:     # (name,), (name, rows) or (name, lanes)
                groups = ((groups[0],) if groups[0] else
                          (f"{groups[1]} "
                           f"{'lanes' if 'cluster' in groups[1] else 'rows'}"
                           f" {groups[2]}",))
            elif fn.re is chain:   # lanes a tile, rows a thread
                groups = (f"gru_bwd_chain_cluster lanes {groups[0]} rows "
                          f"{8 * int(groups[1])}",)
            found.append((groups, dict(re.findall(r"(\w+):(\d+)",
                                                  line))))
            fn = None
    check(any(g[0] == "gru_fwd" and g[5] == "1" for g, _ in found) and
          any(g[0] == "gru_bwd_chain" and g[5] == "1" for g, _ in found),
          "the GRU kernels with W_h in registers are not in the library")
    from repro_torch.kernels.gru import kernel as gk
    cluster = {}    # lanes -> the widest plan of the cluster forward at them
    for hdim in (gk.CLUSTER_HIDDEN, 256):
        for batch in gk.CLUSTER_ROWS:
            ctas, rows = gk.cluster_plan(hdim, batch)
            cluster.setdefault(gk.cluster_ks(rows), (hdim, ctas, rows))
    lanes = sorted(int(g[0].split()[-1]) for g, _ in found
                   if g[0].startswith("gru_fwd_cluster"))
    check(lanes == [4, 8, 16, 32], f"gru_fwd_cluster instantiations for "
                                   f"lanes {lanes}, want [4, 8, 16, 32]")
    chains = sorted(g[0] for g, _ in found
                    if g[0].startswith("gru_bwd_chain_cluster"))
    check(len(chains) == 6, f"gru_bwd_chain_cluster instantiations "
                            f"{chains}, want 6 (lanes x rows of the plans)")
    for groups, use in sorted(found):
        name = groups[0]
        if name.startswith("gru_fwd_cluster"):
            hdim, ctas, rows = cluster[int(name.split()[-1])]
            smem = ext.gru_forward_cluster_smem_bytes(hdim, ctas, rows)
            print(f"resources {name}: REG {use.get('REG')}, STACK "
                  f"{use.get('STACK')}, LOCAL {use.get('LOCAL')}, dynamic "
                  f"shared {smem} bytes at H={hdim}, {ctas} CTAs x {rows} "
                  f"rows", flush=True)
            check(use.get("STACK") == "0" and use.get("LOCAL") == "0",
                  f"{name} spills to local memory: STACK "
                  f"{use.get('STACK')}, LOCAL {use.get('LOCAL')}")
            continue
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


def ssd_bound(bsz, t, h, p, n, chunk, elt=2, peak=PEAK_BF16_PER_S):
    """Each input read once and each output written once (x, b, c and y
    of ``elt`` bytes, f32 la, states and decay); C·Bᵀ once per (b, chunk)
    and per head the causal half of M·X, the decay-weighted M and the
    chunk state, at ``peak`` (bf16: the tensor cores)."""
    nc = t // chunk
    nbytes = (elt * (2.0 * bsz * t * h * p + 2 * bsz * t * n)
              + 4.0 * (bsz * t * h + bsz * nc * h * p * n + bsz * nc * h))
    ops = bsz * nc * (2.0 * chunk * chunk * n + h * (
        p * chunk * (chunk + 1) + 2.0 * chunk * chunk
        + 2.0 * chunk * p * n + chunk * n))
    return bound_ms(nbytes, ops, peak)


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
    from repro_torch.tree import tree_map
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


def check_ssd_tiled(gen, device, cases=SSD_TILED_CASES,
                    key="ssd_chunk_tiled", source="ssd.cu"):
    """``ssd_chunk_tiled`` (any chunk, P, N) at SSD_TILED_CASES: chunk 256
    at mamba2-780m's layer width with head_dim and state 6 in both dtypes
    (or, with ``cases``, ``key`` and ``source``, another route at its
    cases); each output against the plain intra-chunk block in float32 on
    the same inputs (SSD_TOL), timed with CUDA events beside its bound
    (the shape's FLOPs over the peak of its inputs' type) and the plain
    version. Returns the kernel row, timed at the first case, with the
    launches this check made (``kernel_phase_launches``)."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk, ref as sr
    worst, timed = 0.0, {}
    before = sk.LAUNCHES[key]
    for bsz, t, h, p, n, chunk, name in cases:
        dtype = getattr(torch, name)
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)
        dt = torch.nn.functional.softplus(rnd(bsz, t, h) - 3.0)
        a = -torch.exp(rnd(h) * 0.5)
        xw = (rnd(bsz, t, h, p) * dt[..., None]).to(dtype).contiguous()
        bm, c = rnd(bsz, t, n).to(dtype), rnd(bsz, t, n).to(dtype)
        la = (dt * a).contiguous()
        check(sk.route(dtype, p, n, chunk) == key,
              f"ssd {name} P={p} N={n} L={chunk} not on {key}")
        label = f"{key} {name} {bsz}x{t}x{h}x{p} N {n} L {chunk}"
        got = launched(sk.LAUNCHES, key,
                       lambda: sk.forward(xw, la, bm, c, chunk=chunk))
        want = sr.intra_chunk(xw, la, bm, c, chunk=chunk)
        err = 0.0
        for what, g, w, tol in zip(("y", "states", "chunk_decay"), got, want,
                                   (SSD_TOL[name], SSD_TOL["float32"],
                                    SSD_TOL["float32"])):
            err = max(err, allclose_err([(f"{label} {what}", g, w)], tol))
        worst = max(worst, err)
        del got, want
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: sk.forward(xw, la, bm, c, chunk=chunk), 10)
        plain_ms = cuda_ms(lambda: sr.intra_chunk(xw, la, bm, c,
                                                  chunk=chunk), 2)
        bound = ssd_bound(bsz, t, h, p, n, chunk,
                          elt=xw.element_size(),
                          peak=PEAK_BF16_PER_S if dtype == torch.bfloat16
                          else PEAK_FP32_PER_S)
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1], max_abs_err=err, bound=bound)
        print(f"{label}: {ms:.4f} ms a launch, {bound[0] / ms:.4f} of the "
              f"bound {bound[0]:.5f} ms by {bound[1]}; plain {plain_ms:.4f} "
              f"ms; max abs err {err:.3e}", flush=True)
        del xw, la, bm, c
        torch.cuda.empty_cache()
    first = next(iter(timed))
    row = timed[first]
    return dict(name=key, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                replaces="src/repro/kernels/ssd/kernel.py:65",
                max_abs_err=worst, ms=row["ms"], plain_ms=row["plain_ms"],
                bound=row["bound"], library_ms=None, shape=first,
                kernel_phase_launches=sk.LAUNCHES[key] - before,
                by_shape={k: {n: x for n, x in v.items() if n != "bound"}
                          for k, v in timed.items()})


def check_ssd_long(gen, device):
    """``ssd_chunk_sm90_long`` (bf16, P 64, chunk 256, on the tensor cores)
    at SSD_LONG_CASES, as :func:`check_ssd_tiled` holds the tiled pair."""
    return check_ssd_tiled(gen, device, SSD_LONG_CASES,
                           "ssd_chunk_sm90_long", "ssd_sm90.cu")


def check_ssd_f32_long(gen, device):
    """``ssd_chunk_f32_long`` (float32, P 64, chunk 256, on FFMA) at
    SSD_F32_LONG_CASES, as :func:`check_ssd_tiled` holds the tiled
    pair."""
    return check_ssd_tiled(gen, device, SSD_F32_LONG_CASES,
                           "ssd_chunk_f32_long", "ssd.cu")


# ---------------------------------------------------------------------------
# the DIALS paths
# ---------------------------------------------------------------------------
def make_trainer(env, side, *, device, use_kernels, small=False, rounds=1,
                 refresh=1, policy_kind="fnn", gru_hidden=(16, 16),
                 **dials_kw):
    """The loop driver on ``env`` at ``side``: the library's default
    widths with a GRU AIP (``small``: narrow widths, the policy's and the
    AIP's GRU at ``gru_hidden``), ``DIALSConfig()`` cut to ``rounds`` and
    F=``refresh``; ``dials_kw`` sets further ``DIALSConfig`` fields
    (``ckpt_dir``, the async collect, telemetry)."""
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    env_mod, env_cfg = registry.make(env, side=side)
    info = env_cfg.info()
    if small:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions,
                                 kind=policy_kind, hidden=(32,),
                                 gru_hidden=gru_hidden[0])
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru", hidden=(32,),
                                 gru_hidden=gru_hidden[1], epochs=5)
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
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    for table in _count_tables():
        for k in table:
            table[k] = 0
    for tables in (gk.SHAPE_LAUNCHES, gk.STREAM_LAUNCHES, ak.SHAPE_LAUNCHES):
        for by_key in tables.values():
            by_key.clear()


def shape_counts():
    """The GRU wrappers' launches by (A, T, B, H) and the GAE wrappers'
    by (T, B) since the last reset."""
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    return {name: {"x".join(map(str, k)): n for k, n in sorted(tbl.items())}
            for name, tbl in {**gk.SHAPE_LAUNCHES,
                              **ak.SHAPE_LAUNCHES}.items()}


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
    state and the history, for the resume and sharded checks, and the
    ``gru_forward`` launches by stream, for the async path's)."""
    from repro_torch import random as R
    from repro_torch.marl.ppo import PPOConfig
    trainer = make_trainer("warehouse", SIDE, device=device,
                           use_kernels="on", rounds=GRU_POLICY_ROUNDS,
                           refresh=AIP_REFRESH, policy_kind="gru")
    from repro_torch.kernels.gru import kernel as gk
    state, history, counts, by_shape = drive_dials(
        "gru-policy path", trainer, R.key(0, device=device),
        GRU_POLICY_ROUNDS, "policy=cuda,aip=cuda,ppo=cuda")
    streams = dict(gk.STREAM_LAUNCHES["gru_forward"])
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
    return counts, by_shape, state, history, streams


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


def run_async_path(device, smi, serial, serial_streams):
    """The recurrent-policy warehouse path (side=10, ``use_kernels="on"``,
    F=AIP_REFRESH) ASYNC_ROUNDS rounds with the overlapped collect
    (``async_collect=True``, ``max_aip_staleness=2``, ``telemetry_dir``
    under build/), then ASYNC_ZERO_ROUNDS rounds at
    ``max_aip_staleness=0``, against the serial run of the same path
    (``run_gru_policy_path``'s records ``serial`` and its ``gru_forward``
    launches by stream). Checks the tags (``data_round`` [0, 0, 1],
    ``forced_sync`` [True, False, False]), the telemetry log (every round
    record valid, rounds monotone, the run_start/collect_obtain/round/
    run_end events; ``tools/telemetry_report_torch.py --check``),
    ``gru_forward`` launched by the collect worker on a
    stream other than the driver's and by the serial run on the driver's
    alone, and the staleness-0 records bit for bit the serial run's."""
    import shutil
    import torch
    from repro_torch import random as R
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import sinks
    tel_dir = os.path.join(ROOT, "build", "chip_smoke_telemetry")
    shutil.rmtree(tel_dir, ignore_errors=True)
    driver = torch.cuda.current_stream(device).cuda_stream
    check(ASYNC_ZERO_ROUNDS <= len(serial), "async: the serial run is "
                                            "shorter than the bound-0 run")
    runs, counts = {"serial": (serial, serial_streams)}, None
    for label, rounds, kw in (
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
    _telemetry_report(tel_dir)
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
    """``tools/telemetry_report_torch.py --check`` (the port's check of an
    event log) on ``directory``, in process."""
    import contextlib
    import io
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tools import telemetry_report_torch
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = telemetry_report_torch.main([directory, "--check", *flags])
    print(f"telemetry_report_torch {os.path.basename(directory)} "
          f"{' '.join(flags)}: {out.getvalue().strip()[-300:]}", flush=True)
    check(rc == 0, f"telemetry_report_torch --check {flags} failed on "
                   f"{directory}:\n{out.getvalue()[-2000:]}")


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
    2. in this process, step K = FAULT_KILL_ROUND restored into a
       one-shard runner (two slices onto one shard, a ``restore_reshard``
       event) and run on for rounds K..; the loop driver's flat-manager
       restore of the same step bit for bit the one-shard restore;
    3. a host drop: rank 1 SIGKILLed at the top of round K, the survivor
       reassigned (records n_shards 2 before round K and 1 from it,
       dead_hosts [1] and reassigned 1 at round K alone) and bit for bit
       (2)'s final state; the merged event log passing
       ``tools/telemetry_report_torch.py --check`` with its
       ``host_death`` and ``elastic_reassign``;
    4. a recovery around the external coordinator under the chaos spec
       FAULT_CHAOS: rank 1 SIGKILLed (-9), the survivor re-executed as
       generation 1, resuming rounds K.. solo, bit for bit (2)'s final
       state, within the two-rank tolerances of (1), the merged log
       passing ``--check --expect-recovery``;
    5. the sharded overlapped collect: bound 0 bit for bit (1)'s records
       and its step FAULT_ZERO_ROUNDS state over the same rounds, bound 2
       tags [0, 0, 1].

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
    kill = FAULT_KILL_ROUND
    check(0 < kill < FAULT_ROUNDS and 0 < FAULT_ZERO_ROUNDS <= FAULT_ROUNDS,
          f"fault path: kill round {kill} and bound-0 rounds "
          f"{FAULT_ZERO_ROUNDS} must fall inside a run of {FAULT_ROUNDS}")
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

    # (2) restore step K (one the run saved): one shard in this process,
    # and the loop driver
    d2 = os.path.join(base, "one_shard")
    os.makedirs(os.path.join(d2, "ckpt"))
    shutil.copytree(os.path.join(ck1, f"step_{kill}"),
                    os.path.join(d2, "ckpt", f"step_{kill}"))
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
    check(restored["round"] == flat["round"] == kill,
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
    check([x["round"] for x in history] == list(range(kill, FAULT_ROUNDS)),
          f"fault (2): rounds {[x['round'] for x in history]}")
    reshard = [e for e in sinks.read_jsonl(sinks.proc_path(
        os.path.join(d2, "tel"), 0)) if e["event"] == "restore_reshard"]
    check(bool(reshard) and (reshard[0]["old_shards"],
                             reshard[0]["new_shards"]) == (2, 1),
          f"fault (2): restore_reshard events {reshard}")
    ref_state = _fault_leaves(state)
    print(f"fault (2) restore of step {kill} on {smi}: one shard "
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
    after = FAULT_ROUNDS - kill - 1
    check([x["n_shards"] for x in hist] == [2] * kill + [1] * (after + 1),
          f"fault (3): n_shards {[x['n_shards'] for x in hist]}")
    check([x["dead_hosts"] for x in hist] == [[]] * kill + [[1]]
          + [[]] * after,
          f"fault (3): dead_hosts {[x['dead_hosts'] for x in hist]}")
    check([x["reassigned"] for x in hist] == [0] * kill + [1] + [0] * after,
          f"fault (3): reassigned {[x['reassigned'] for x in hist]}")
    check(_same(out["state"], ref_state),
          f"fault (3): the survivor's final state is not bit for bit the "
          f"one-shard resume from step {kill}")
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
    check([x["round"] for x in hist] == list(range(kill, FAULT_ROUNDS)),
          f"fault (4): resumed rounds {[x['round'] for x in hist]}")
    _fault_kernels("fault (4) survivor", out["counts"])
    add(out["counts"])
    check(_same(out["state"], ref_state),
          f"fault (4): the survivor's final state is not bit for bit the "
          f"one-shard resume from step {kill}")
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
    t_round = first_t("round", round=kill)
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
    zero_step, _ = _restore_full(device, ck1, FAULT_ZERO_ROUNDS)
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
    check(_same(ranks[0]["async"]["bound0"]["state"], zero_step),
          f"fault (5): the bound-0 state is not bit for bit (1)'s step "
          f"{FAULT_ZERO_ROUNDS}")
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
# torch_run.py's --fast fig3_learning cell (3 rounds of F=10,
# benchmarks/run.py:78-79) cut in depth to 1 round of F=2
HARNESS_ENV, HARNESS_ROUNDS, HARNESS_INNER = "warehouse", 1, 2
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
    widths (HARNESS_ROUNDS rounds of F=HARNESS_INNER, the reference's
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


def with_model_cfg(spec, **kw):
    """``spec`` with its model config's fields ``kw`` replaced (an
    enc-dec's decoder config)."""
    import dataclasses
    if spec.kind == "encdec":
        return dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, decoder=dataclasses.replace(spec.cfg.decoder, **kw)))
    return dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **kw))


class RouteLog:
    """The MoE routes of a run, in call order: every result of
    ``repro_torch.nn.moe.route_groups`` while :meth:`record` is open. A
    second run under :meth:`replay` takes those routes in place of its
    own: bf16 rounding that differs between two prefills can flip a top-k
    choice on a near tie, and the flash-against-plain comparison is of
    the attention kernel's numerics, not of such a flip. ``replay`` counts
    the (token, layer) expert sets its own routing would have changed."""

    def __init__(self):
        self.routes, self.flips, self.choices = [], 0, 0

    def _patched(self, fn):
        import contextlib
        from repro_torch.nn import moe

        @contextlib.contextmanager
        def ctx():
            real = moe.route_groups
            moe.route_groups = lambda p, x, cfg: fn(real, p, x, cfg)
            try:
                yield self
            finally:
                moe.route_groups = real
        return ctx()

    def record(self):
        def rec(real, p, x, cfg):
            out = real(p, x, cfg)
            self.routes.append(out)
            return out
        return self._patched(rec)

    def replay(self):
        it = iter(self.routes)

        def rep(real, p, x, cfg):
            own, out = real(p, x, cfg)[1], next(it)
            self.flips += int((own.sort(-1).values
                               != out[1].sort(-1).values).any(-1).sum())
            self.choices += own.shape[0] * own.shape[1]
            return out
        return self._patched(rep)

    def dropped_share(self) -> float:
        """The share of (token, k) pairs the recorded routes dropped."""
        kept = sum(float(r[3].sum()) for r in self.routes)
        return 1.0 - kept / sum(r[3].numel() for r in self.routes)

    def aux(self) -> dict:
        """The aux terms summed over the recorded MoE layers."""
        return {name: sum(float(r[5][name]) for r in self.routes)
                for name in ("load_balance", "z_loss")}


def _lm_batch(spec, b, t, gen, device):
    """Tokens and the stub frontend's input (frames or patches), drawn
    from ``gen`` on the card."""
    import torch
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                     device=device)}
    if spec.kind == "encdec":
        batch["frames"] = torch.randn(b, spec.n_frames, spec.cfg.d_model,
                                      generator=gen, device=device
                                      ).to(spec.cfg.dtype)
    elif spec.kind == "vlm":
        batch["patches"] = torch.randn(b, spec.n_patches, spec.vision_dim,
                                       generator=gen, device=device
                                       ).to(spec.cfg.dtype)
    return batch


def serve_arch(arch, device, smi, reduced=False):
    """One architecture of ``run_lm_archs_path`` (its registry's reduced
    config with ``reduced``); returns its flash launches."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import steps
    from repro_torch.models import api
    spec = registry.get(arch, reduced=reduced)
    label = arch + ("-reduced" if reduced else "")
    full = steps.model_cfg(spec).n_layers
    if arch in LM_DEPTH_CUT and not reduced:
        spec = with_model_cfg(spec, n_layers=LM_DEPTH_CUT[arch])
    cfg = steps.model_cfg(spec)
    flash = with_model_cfg(spec, use_flash=True)
    plain = with_model_cfg(spec, use_flash=False)
    want = sum(ls.mixer == "attn" for ls in cfg.period) * cfg.repeats \
        + (cfg.repeats if cfg.shared is not None else 0)
    check(want == LM_FLASH_LAUNCHES[label],
          f"{label}: {want} self-attention blocks a prefill, not "
          f"{LM_FLASH_LAUNCHES[label]}")
    # the kernel each self-attention block's dtype and head_dim route to
    kernels_of = {fk.route(ls.attn.dtype, ls.attn.dh)
                  for ls in cfg.period + (cfg.shared,)
                  if ls is not None and ls.mixer == "attn"}
    check(len(kernels_of) <= 1, f"{label}: attention blocks on {kernels_of}")
    route = kernels_of.pop() if kernels_of else "flash_fwd_sm90"
    arch = label
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_params(flash, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.param_count(params)
    print(f"lm {arch} on {smi}: {cfg.n_layers} of {full} layers"
          f"{' (depth cut)' if cfg.n_layers < full else ''}, init "
          f"{init_s:.3f} s, param_count {n_params}, active_param_count "
          f"{api.active_param_count(params, spec)}, param_bytes "
          f"{api.param_bytes(params)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(1)
    b, t = LM_PROMPT
    if spec.kind == "encdec":
        t = WHISPER_TARGET
    batch = _lm_batch(spec, b, t, gen, device)
    for warm in (flash, plain):    # untimed: first-use costs of each path
        steps.make_prefill_step(warm)(params, batch)
    torch.cuda.synchronize()
    routes = RouteLog()
    reset_counts()
    t0 = time.perf_counter()
    with routes.record():
        logits_k = steps.make_prefill_step(flash)(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = launch_counts()
    t0 = time.perf_counter()
    with routes.replay():
        logits_p = steps.make_prefill_step(plain)(params, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(launch_counts() == counts, f"{arch}: the plain prefill launched "
                                     f"a kernel")
    check(counts["flash_attention"] == want and counts[route] == want,
          f"{arch}: prefill launched flash {counts['flash_attention']} times "
          f"({ {r: counts[r] for r in fk.ROUTES} }), not {want}, all on "
          f"{route}")
    check(all(v == 0 for k, v in counts.items()
              if not k.startswith("flash")),
          f"{arch}: the prefill launched another kernel: {counts}")
    check(tuple(logits_k.shape) == (b, 1, cfg.vocab),
          f"{arch}: prefill logits of shape {tuple(logits_k.shape)}")
    err = allclose_err([(f"{arch} prefill last logits, flash vs plain",
                         logits_k, logits_p)], LOGIT_TOL)
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    moe = ""
    if routes.routes:
        aux = routes.aux()
        check(all(math.isfinite(v) for v in aux.values()),
              f"{arch}: non-finite MoE aux terms {aux}")
        moe = (f"; MoE: {len(routes.routes)} layers, dropped (token, k) "
               f"share {routes.dropped_share():.6f}, aux {aux}, routes the "
               f"plain prefill would have changed {routes.flips} of "
               f"{routes.choices} (replayed)")
    print(f"lm {arch} on {smi}: prefill B={b} T={t} {prefill_s:.3f} s with "
          f"the flash kernel ({counts['flash_attention']} launches), "
          f"{plain_s:.3f} s plain; last logits max abs diff {err:.4e} (max "
          f"|logit| {float(logits_p.abs().max()):.4f}), argmax agrees "
          f"{agree}/{b}{moe}", flush=True)
    del logits_k, logits_p, batch

    serve = steps.make_serve_step(flash)
    binp = _lm_batch(spec, LM_DECODE_BATCH, LM_DECODE_PROMPT, gen, device)
    prompt = binp.pop("tokens")
    max_len = LM_DECODE_PROMPT + LM_DECODE_NEW
    with torch.inference_mode():
        caches = api.init_caches(params, flash, LM_DECODE_BATCH, max_len,
                                 batch_inputs=binp)
    finite, out = [], []
    for i in range(LM_DECODE_PROMPT):
        logits, caches = serve(params, prompt[:, i:i + 1], caches, i)
        finite.append(torch.isfinite(logits).all())
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE_PROMPT, max_len):
        logits, caches = serve(params, tok, caches, i)
        finite.append(torch.isfinite(logits).all())
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (LM_DECODE_BATCH, 1, cfg.vocab),
          f"{arch}: decode logits of shape {tuple(logits.shape)}")
    check(bool(torch.stack(finite).all()), f"{arch}: non-finite decode "
                                           f"logits")
    check(tuple(torch.cat(out, 1).shape) == (LM_DECODE_BATCH, LM_DECODE_NEW),
          f"{arch}: decode produced {tuple(torch.cat(out, 1).shape)}")
    print(f"lm {arch} on {smi}: decode B={LM_DECODE_BATCH}, "
          f"{LM_DECODE_NEW} steps after a {LM_DECODE_PROMPT}-token prompt "
          f"in {decode_s:.3f} s ({LM_DECODE_BATCH * LM_DECODE_NEW / decode_s:.3f}"
          f" tok/s); peak memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    del params, caches, logits
    torch.cuda.empty_cache()
    return counts


def run_lm_archs_path(device, smi):
    """The registry's other eight architectures (LM_ARCHS), then the
    reduced configs of LM_REDUCED (gemma2-9b's: head_dim 16, which
    routes to ``flash_fwd_sm90_padded``), served on the card, each in
    turn and freed before the next: the prefill step with
    the flash kernel and without it, each timed after an untimed call
    (their last-position logits within
    LOGIT_TOL times max(1, max |logit|); the plain run replays the flash
    run's MoE routes, see ``RouteLog``), each self-attention block
    launching once the kernel its dtype and head_dim route to
    (``flash_fwd_sm90``, or ``flash_fwd_sm90_padded`` for the reduced
    gemma2-9b; LM_FLASH_LAUNCHES) and nothing else launched (no SSD kernel on any
    model path), then a greedy decode
    through ``make_serve_step`` (finite logits of the right shape).
    Returns the launch counts of the flash prefills."""
    total = {}
    for arch, reduced in ([(a, False) for a in LM_ARCHS]
                          + [(a, True) for a in LM_REDUCED]):
        for k, n in serve_arch(arch, device, smi, reduced).items():
            total[k] = total.get(k, 0) + n
    check(total["flash_attention"] == sum(LM_FLASH_LAUNCHES.values()),
          f"lm architectures: {total['flash_attention']} flash launches")
    return total


def run_ssm_path(device):
    """``ssm_layer(use_kernel=True)`` at mamba2-780m's layer width on
    (2, 8192, 1536) bf16 activations, against ``use_kernel=False``: the
    counted call (one launch of ``ssd_chunk_sm90``), then one untimed
    warm-up call of each and the median of SSM_TIMED synchronised calls of
    each, then the kernel call traced as ``traced_calls`` takes it (its
    one ``ssd_chunk_sm90`` launch a call checked against the wrapper's
    count) for the SSD kernel's share of the layer's device time; the same
    layer at chunk SSM_TILED_CHUNK (one launch of ``ssd_chunk_sm90_long``)
    and, in float32 (weights and activations cast), at that chunk (one
    launch of ``ssd_chunk_f32_long``), each against its plain call.
    Returns the launch counts of the three counted calls."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import common
    from repro_torch.nn import ssm
    from repro_torch.tree import tree_map
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

    # the same layer at chunk SSM_TILED_CHUNK: past ssd_chunk_sm90's
    # chunks, on ssd_chunk_sm90_long
    tiled = dataclasses.replace(cfg, chunk=SSM_TILED_CHUNK)
    tiled_layer = {k: (lambda k=k: ssm.ssm_layer(params, x, tiled,
                                                 use_kernel=k))
                   for k in (True, False)}
    # and in float32 there: ssd_chunk_f32_long
    f32 = dataclasses.replace(tiled, dtype=torch.float32)
    params32 = tree_map(lambda v: v.float(), params)
    x32 = x.float()
    f32_layer = {k: (lambda k=k: ssm.ssm_layer(params32, x32, f32,
                                               use_kernel=k))
                 for k in (True, False)}
    with torch.inference_mode():
        reset_counts()
        cold_s, y_k = timed(layer[True])
        tiled_s, y_kt = timed(tiled_layer[True])
        f32_s, y_kf = timed(f32_layer[True])
        counts = launch_counts()
        _, y_p = timed(layer[False])
        tiled_plain_s, y_pt = timed(tiled_layer[False])
        f32_plain_s, y_pf = timed(f32_layer[False])
        warm = {}
        for k, fn in layer.items():
            fn()
            warm[k] = statistics.median(timed(fn)[0]
                                        for _ in range(SSM_TIMED))
        summary = device_summary(
            traced_calls(layer[True], PROFILE_ITERS, "ssd_chunk_sm90",
                         "ssd_chunk_sm90"), "ssd_chunk_sm90")
    ssd_counts = {k: counts[k] for k in counts
                  if k.startswith("ssd_") and k != "ssd_intra_chunk"}
    check(counts["ssd_intra_chunk"] == 3 and ssd_counts == {
        **{k: 0 for k in ssd_counts}, "ssd_chunk_sm90": 1,
        "ssd_chunk_sm90_long": 1, "ssd_chunk_f32_long": 1},
          f"ssm_layer launched the SSD kernels {counts['ssd_intra_chunk']} "
          f"times ({ssd_counts}), not ssd_chunk_sm90 once at chunk "
          f"{cfg.chunk} and ssd_chunk_sm90_long and ssd_chunk_f32_long once "
          f"each at {tiled.chunk}")
    for y, dtype in ((y_k, cfg.dtype), (y_kt, cfg.dtype),
                     (y_kf, torch.float32)):
        check(tuple(y.shape) == (b, t, cfg.d_model) and y.dtype == dtype,
              f"ssm_layer output {tuple(y.shape)} {y.dtype}")
    err = allclose_err([("ssm_layer, kernel vs plain", y_k, y_p)],
                       SSM_LAYER_TOL)
    err_t = allclose_err([(f"ssm_layer at chunk {tiled.chunk}, kernel vs "
                           f"plain", y_kt, y_pt)], SSM_LAYER_TOL)
    err_f = allclose_err([(f"ssm_layer float32 at chunk {f32.chunk}, "
                           f"kernel vs plain", y_kf, y_pf)],
                         SSD_TOL["float32"])
    print(f"ssm layer at chunk {tiled.chunk} (ssd_chunk_sm90_long): cold "
          f"{tiled_s:.4f} s with the kernel, {tiled_plain_s:.4f} s plain; "
          f"max abs diff {err_t:.4e} (max |y| "
          f"{float(y_pt.abs().max()):.4f})", flush=True)
    print(f"ssm layer float32 at chunk {f32.chunk} (ssd_chunk_f32_long): "
          f"cold {f32_s:.4f} s with the kernel, {f32_plain_s:.4f} s plain; "
          f"max abs diff {err_f:.4e} (max |y| "
          f"{float(y_pf.abs().max()):.4f})", flush=True)
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


def _train_batch(spec, b, t, step, device):
    """Batch ``step`` of the synthetic stream (``pipeline.lm_iterator``,
    seed 0) on the card, with frames or patches drawn from a key of their
    own for an enc-dec or VLM spec."""
    from repro_torch import random as R
    from repro_torch.data import pipeline, synthetic
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    batch = next(pipeline.lm_iterator(0, b, t, cfg.vocab, start_step=step,
                                      device=device))
    key = R.fold_in(R.key(1, device=device), step)
    if spec.kind == "encdec":
        batch["frames"] = synthetic.frames(key, b, spec.n_frames,
                                           spec.cfg.d_model)
    elif spec.kind == "vlm":
        batch["patches"] = synthetic.patches(key, b, spec.n_patches,
                                             spec.vision_dim)
    return batch


def _finite(tree) -> bool:
    import torch
    from repro_torch.tree import leaves
    return all(bool(torch.isfinite(x).all()) for x in leaves(tree)
               if x.is_floating_point())


def _moved(master, params) -> int:
    """Leaves of ``master`` that differ from the initial params."""
    import torch
    from repro_torch.tree import leaves
    return sum(not torch.equal(m, p.float())
               for m, p in zip(leaves(master), leaves(params)))


def train_arch(label, spec, shape, n_steps, device, smi, microbatches=1):
    """``n_steps`` of ``make_train_step`` (the first untimed) from params
    drawn on the card: every loss and grad norm finite, grad norms above
    0, the step-0 cross-entropy within 1 of ln V (the loss itself where
    there is no MoE aux term), ``opt["step"]`` the number of steps, the
    fp32 master moved from the initial params (the lr is 0 at step 0) and
    every leaf of params and AdamW state finite. Returns the record."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = steps.model_cfg(spec)
    b, t = shape
    if spec.kind == "encdec":
        t = WHISPER_TARGET
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params0 = steps.init_params(spec, seed=0, device=device)
    opt = adamw.init(params0, per_agent=False)
    step = steps.make_train_step(spec, microbatches=microbatches)
    params, metrics, times = params0, [], []
    for i in range(n_steps):
        batch = _train_batch(spec, b, t, i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        del batch
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(m[k]) for m in metrics for k in m),
          f"{label}: non-finite loss or metrics {metrics}")
    check(all(m["grad_norm"] > 0 for m in metrics),
          f"{label}: a zero grad norm {metrics}")
    xent0, ln_v = metrics[0]["xent"], math.log(cfg.vocab)
    check(abs(xent0 - ln_v) < 1.0,
          f"{label}: step-0 cross-entropy {xent0} not within 1 of ln V "
          f"{ln_v}")
    check(int(opt["step"]) == n_steps, f"{label}: opt step "
                                       f"{int(opt['step'])}")
    moved = _moved(opt["master"], params0)
    check(moved > 0, f"{label}: master never moved")
    check(_finite(params) and _finite(opt), f"{label}: a non-finite leaf")
    timed = times[1:]
    step_s = sum(timed) / len(timed)
    rec = {"params": api.param_count(params0), "steps": n_steps,
           "step_s": timed, "tok_s": b * t / step_s,
           "peak_bytes": peak, "loss": [m["loss"] for m in metrics],
           "xent0": xent0, "grad_norm": [m["grad_norm"] for m in metrics],
           "first_s": times[0], "moved_leaves": moved}
    print(f"lm training {label} on {smi}: {rec['params']} params, B={b} x "
          f"T={t}, {microbatches} microbatch(es), {n_steps} steps: "
          f"first {times[0]:.3f} s, then {[round(x, 4) for x in timed]} s a "
          f"step ({rec['tok_s']:.1f} tok/s); loss "
          f"{[round(x, 4) for x in rec['loss']]} (ln V {ln_v:.4f}), grad "
          f"norm {[round(x, 4) for x in rec['grad_norm']]}; master moved "
          f"in {moved} leaves; peak memory {peak} bytes", flush=True)
    del params0, params, opt
    torch.cuda.empty_cache()
    return rec


def _card_vs_cpu(device, smi):
    """Reduced tinyllama in float32 on the card against the CPU, from the
    same params and batches: the gradients of ``make_value_and_grad``
    leaf by leaf, then two ``make_train_step`` steps at the shipped
    schedule (loss, grad norm, params and AdamW state), and microbatches 2
    against 1 on the card, each within LM_TRAIN_TOL of each leaf's largest
    magnitude. (Not at a large learning rate: Adam's g/(|g| + eps) carries
    a rounding difference in a gradient that cancels to near eps into the
    master at the lr's size, 4e-4 relative at peak lr 100 on the card.)"""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, tree_map
    spec = registry.get(LM_TRAIN_ARCH, reduced=True)
    f32 = lambda ls: dataclasses.replace(ls, dtype=torch.float32, **{
        n: dataclasses.replace(getattr(ls, n), dtype=torch.float32)
        for n in ("attn", "mlp") if getattr(ls, n) is not None})
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, dtype=torch.float32,
        period=tuple(f32(ls) for ls in spec.cfg.period)))
    cpu_params = steps.init_params(spec, seed=0, device="cpu")
    batches = [_train_batch(spec, 4, 128, i, "cpu") for i in range(2)]
    on = lambda tree, dev: tree_map(lambda x: x.to(dev), tree)

    def grads(dev):
        (loss, _), g = steps.make_value_and_grad(api.loss_fn(spec))(
            on(cpu_params, dev), on(batches[0], dev))
        return {"loss": loss}, g

    def run(dev, microbatches):
        params = on(cpu_params, dev)
        opt = adamw.init(params, per_agent=False)
        step = steps.make_train_step(spec, microbatches=microbatches)
        for b in batches:
            params, opt, m = step(params, opt, on(b, dev))
        return m, (params, opt)

    def err(a, b):
        (ma, ta), (mb, tb) = a, b
        worst = max(abs(float(ma[k]) - float(mb[k]))
                    / max(1.0, abs(float(mb[k]))) for k in mb)
        for x, y in zip(leaves(ta), leaves(tb)):
            x, y = x.cpu().double(), y.cpu().double()
            scale = float(y.abs().max())
            if scale > 0:
                worst = max(worst, float((x - y).abs().max()) / scale)
        return worst

    grad_err = err(grads(device), grads("cpu"))
    card = run(device, 1)
    card_err = err(card, run("cpu", 1))
    mb_err = err(run(device, 2), card)
    print(f"lm training card vs cpu on {smi}: reduced {LM_TRAIN_ARCH} "
          f"float32: gradients max relative err {grad_err:.3e}; 2 steps "
          f"{card_err:.3e} (loss {float(card[0]['loss']):.6f}); microbatches "
          f"2 vs 1 on the card {mb_err:.3e} (tol {LM_TRAIN_TOL})",
          flush=True)
    for name, e in (("gradients", grad_err), ("two steps", card_err),
                    ("microbatches 2 vs 1", mb_err)):
        check(e <= LM_TRAIN_TOL, f"lm training: card vs cpu {name} {e}")
    return {"gradients": grad_err, "card_vs_cpu": card_err,
            "microbatches_2_vs_1": mb_err}


def run_lm_training_path(device, smi):
    """LM training on the card (see LM_TRAIN_ARCH): tinyllama at full
    width and depth, one step of each of LM_TRAIN_FAMILIES at full width,
    two of each of LM_TRAIN_REDUCED reduced, the card against the CPU.
    Every kernel's launch count must stay 0 over the path. Returns the
    launch counts."""
    from repro_torch.configs import registry
    reset_counts()
    out = {LM_TRAIN_ARCH: train_arch(
        f"{LM_TRAIN_ARCH} (full, 22 layers)", registry.get(LM_TRAIN_ARCH),
        LM_TRAIN_SHAPE, LM_TRAIN_STEPS, device, smi,
        microbatches=LM_TRAIN_MICROBATCHES)}
    for arch in LM_TRAIN_FAMILIES:
        out[arch] = train_arch(f"{arch} (full)", registry.get(arch),
                               LM_TRAIN_FAMILY_SHAPE, 2, device, smi)
    for arch in LM_TRAIN_REDUCED:
        out[arch] = train_arch(f"{arch} (reduced)",
                               registry.get(arch, reduced=True), (2, 128), 2,
                               device, smi)
    out["card_vs_cpu"] = _card_vs_cpu(device, smi)
    counts = launch_counts()
    check(all(n == 0 for n in counts.values()),
          f"lm training launched a kernel: {counts}")
    print(f"lm training summary on {smi}: " + json.dumps(out), flush=True)
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

def run_wide_gru_path(device):
    """Warehouse side=2 (4 agents) at narrow widths but with the
    recurrent policy's GRU at WIDE_GRU_HIDDEN[0] and the AIP's at
    WIDE_GRU_HIDDEN[1], both above 128 (the forward on the cluster
    kernel, the backward on the cluster chain, each where its route
    takes it), one round of F=2 through the
    kernels (counted: every GRU launch at those widths, forward and
    backward, each on its route), then the same round through the plain
    versions from the same key: the AIP's and the policy's params within
    1e-4 and the AIP's CE within 1e-5, as the small-input check compares
    the AIP's. Every GRU and GAE kernel is then held to its plain version
    at each shape the round launched it (``check_at_launched_shapes``:
    among them partial tiles, B < the tile's rows). Returns (counts,
    counts by shape, {kernel row: errors}), the GRU's under the rows of
    its routes."""
    import torch
    from repro_torch import random as R
    from repro_torch.kernels import build
    from repro_torch.kernels.gru import kernel as gk
    from repro_torch.tree import leaves
    out = {}
    for mode in ("on", "off"):
        trainer = make_trainer("warehouse", 2, device=device,
                               use_kernels=mode, small=True, rounds=1,
                               refresh=2, policy_kind="gru",
                               gru_hidden=WIDE_GRU_HIDDEN)
        key = R.key(1, device=device)
        if mode == "on":
            state, hist, counts, by_shape = drive_dials(
                "wide gru path", trainer, key, 1,
                "policy=cuda,aip=cuda,ppo=cuda")
        else:
            state, hist = trainer.run(key)
            torch.cuda.synchronize()
        out[mode] = (state, hist[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ext = build.extension()
    routes = {"gru_forward": lambda shape: gk.forward_route(
                  shape, sms, ext.gru_forward_cluster_max_active),
              "gru_backward": lambda shape: gk.backward_route(
                  shape, sms, ext.gru_backward_cluster_max_active)}
    for name, route_of in routes.items():
        widths = {int(k.split("x")[-1]) for k in by_shape[name]}
        check(widths == set(WIDE_GRU_HIDDEN),
              f"wide gru path: {name} launched at hidden {sorted(widths)}, "
              f"not at {WIDE_GRU_HIDDEN}")
        want = {}
        for k, n in by_shape[name].items():
            kind = route_of(tuple(int(x) for x in k.split("x")))
            want[kind] = want.get(kind, 0) + n
        got = {kind: counts[f"{name}_{kind}"] for kind in want}
        check(got == want and want.get("resident", 0) == 0,
              f"wide gru path: {name} launches by route {got}, the shapes "
              f"route {want}")
    for name in ("gru_forward_cluster", "gru_backward_cluster"):
        check(counts[name] > 0, f"wide gru path: no launch of {name}")
    (s_on, h_on), (s_off, h_off) = out["on"], out["off"]
    diff = lambda a, b: max(max_err(x, y)
                            for x, y in zip(leaves(a), leaves(b)))
    aip_err = diff(s_on["aips"], s_off["aips"])
    policy_err = diff(s_on["ials"]["params"], s_off["ials"]["params"])
    ce_err = max(abs(h_on[k] - h_off[k])
                 for k in ("aip_ce_before", "aip_ce_after"))
    print(f"wide gru path (policy GRU {WIDE_GRU_HIDDEN[0]}, AIP GRU "
          f"{WIDE_GRU_HIDDEN[1]}), kernels vs plain: aip params max abs err "
          f"{aip_err:.3e}, policy params {policy_err:.3e}, aip CE max abs "
          f"err {ce_err:.3e}, gs_return {h_on['gs_return']:.6f} vs "
          f"{h_off['gs_return']:.6f}", flush=True)
    check(aip_err <= 1e-4 and policy_err <= 1e-4 and ce_err <= 1e-5,
          "wide gru path: kernel path and plain path disagree")
    errs = check_at_launched_shapes(device, by_shape, "the wide gru path")
    rows_of = {"gru_forward": "gru_forward_cluster",
               "gru_backward": "gru_backward_cluster"}
    errs = {rows_of.get(n, n): e for n, e in errs.items()}
    return counts, by_shape, errs


def _mesh_spec(layers=None, f32=False, **cfg_kw):
    """tinyllama-1.1b (full width; ``layers`` cuts the depth), or its
    reduced config in float32."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    if f32:
        spec = registry.get(LM_TRAIN_ARCH, reduced=True)
        f = lambda ls: dataclasses.replace(ls, dtype=torch.float32, **{
            n: dataclasses.replace(getattr(ls, n), dtype=torch.float32)
            for n in ("attn", "mlp") if getattr(ls, n) is not None})
        return dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, dtype=torch.float32,
            period=tuple(f(ls) for ls in spec.cfg.period), **cfg_kw))
    spec = registry.get(LM_TRAIN_ARCH)
    if layers is not None:
        cfg_kw["n_layers"] = layers
    return with_model_cfg(spec, **cfg_kw)


def _mesh_opt_at(opt, step: int):
    """AdamW state whose step counter reads ``step`` (a non-zero lr)."""
    import torch
    return {**opt, "step": torch.full_like(opt["step"], step)}


def _pods(anchor_params, n_pods):
    """Each pod's local params after its inner steps: the anchor moved by
    a seeded perturbation of its own."""
    import torch
    from repro_torch.tree import tree_map
    out = []
    for p in range(n_pods):
        gen = torch.Generator(device="cpu").manual_seed(100 + p)
        out.append(tree_map(lambda x: x - 0.01 * (p + 1) * torch.randn(
            x.shape, generator=gen).to(x.device, x.dtype), anchor_params))
    return out


def _outer_expected(anchor_params, pods, cfg):
    """The DIALS-outer step on one process from every pod's params: the
    pod mean of the deltas (int8: of each pod's dequantized delta), the
    Nesterov update from zero velocity."""
    import torch
    from repro_torch.optim import compress as comp
    from repro_torch.tree import leaves, unflatten_like
    flat_a = leaves(anchor_params)
    means = []
    for i, a in enumerate(flat_a):
        ds = [a.float() - leaves(p)[i].float() for p in pods]
        if cfg.compress_int8:
            ds = [comp.decompress(*comp.compress(d, torch.zeros_like(d))[:2],
                                  d.shape) for d in ds]
        means.append(torch.stack(ds).mean(0))
    out = []
    for a, d in zip(flat_a, means):
        vel = d
        step_dir = cfg.momentum * vel + d if cfg.nesterov else vel
        out.append((a.float() - cfg.outer_lr * step_dir).to(a.dtype))
    return unflatten_like(anchor_params, out)


def _mesh_references(device):
    """The single-device values the mesh ranks are held to, on the card:
    tinyllama's step-0 loss and grad norm, its plain prefill's last
    logits, its decode logits; the reduced float32 step; the outer
    steps' expected params."""
    import torch
    from repro_torch.configs import shapes
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, outer
    from repro_torch.tree import leaves, tree_map
    refs = {}
    spec = _mesh_spec(MESH_TRAIN_LAYERS)
    params = steps.init_params(spec, seed=0, device=device)
    opt = _mesh_opt_at(adamw.init(params, per_agent=False), 100)
    batch = _train_batch(spec, *MESH_TRAIN_SHAPE, 0, device)
    _, _, m = steps.make_train_step(spec)(params, opt, batch)
    refs["train"] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del params, opt, m
    torch.cuda.empty_cache()
    spec = _mesh_spec(MESH_SERVE_LAYERS)
    params = steps.init_params(spec, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    tokens = torch.randint(0, spec.cfg.vocab, MESH_PREFILL, generator=gen,
                           device=device, dtype=torch.int32)
    refs["prefill"] = steps.make_prefill_step(spec)(
        params, {"tokens": tokens}).float().cpu()
    dshape = shapes.Shape("decode_mesh", MESH_DECODE_SLOTS, MESH_PREFILL[0],
                          "decode")
    caches = steps.build_caches(params, spec, dshape)
    serve = steps.make_serve_step(spec)
    logs = []
    for i in range(MESH_DECODE_STEPS):
        lg, caches = serve(params, tokens[:, i:i + 1], caches, i)
        logs.append(lg.float().cpu())
    refs["decode"] = torch.stack(logs)
    refs["tokens"] = tokens.cpu()
    del params, caches
    torch.cuda.empty_cache()
    spec = _mesh_spec(f32=True)
    params = steps.init_params(spec, seed=0, device=device)
    opt = _mesh_opt_at(adamw.init(params, per_agent=False), 100)
    batch = _train_batch(spec, 4, 128, 0, device)
    p2, _, m = steps.make_train_step(spec)(params, opt, batch)
    refs["f32"] = {"loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"]),
                   "params": [x.cpu() for x in leaves(p2)]}
    anchor = tree_map(lambda x: x.cpu(), params)
    pods = _pods(anchor, 2)
    refs["outer"] = {
        kind: [x for x in leaves(_outer_expected(anchor, pods, outer.OuterConfig(
            compress_int8=kind == "int8")))]
        for kind in ("fp32", "int8")}
    return refs


def _rel(a, b) -> float:
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _mesh_rank(root, refs_path):
    """One rank of the LM mesh phase on cuda:0 (``bootstrap.spawn_local``):
    the train, prefill, decode, outer and float32 runs of
    ``run_lm_mesh_path``, each timed, with the errors against ``refs``,
    the flash launches of the prefill, the collectives of one decode step
    by kind and the peak bytes of the rank. Returns plain values."""
    import faulthandler
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.distributed import mesh as mesh_lib
    # a native fault's Python stacks, and the runs reached, in a file a
    # rank (the parent prints its tail when a rank dies)
    log = open(_mesh_rank_log(os.environ["DIALS_PROCESS_ID"]), "w")
    faulthandler.enable(file=log, all_threads=True)
    # one host thread a rank: four ranks and the dry-run share the cores
    torch.set_num_threads(1)
    refs = torch.load(refs_path)
    with mesh_lib.host_staged_collectives():
        out = _mesh_rank_runs(refs, log)
    out["staged"] = dict(mesh_lib.STAGE_STATS)
    return out


def _mesh_rank_log(rank) -> str:
    return os.path.join(ROOT, "build", f"chip_smoke_mesh_rank{rank}.log")


def _mesh_rank_runs(refs, log):
    """The runs of :func:`_mesh_rank` (inside its staging mode); each
    run's name goes to ``log`` as it starts."""
    import torch
    from repro_torch.configs import shapes
    from repro_torch.distributed import bootstrap
    from repro_torch.kernels import build, dispatch
    from repro_torch.launch import dryrun, mesh as launch_mesh, steps
    from repro_torch.optim import adamw, outer
    from repro_torch.tree import leaves
    ctx = bootstrap.bootstrap()
    device = dispatch.resolve_device("cuda:0")
    build.extension()                      # built by the parent: a load
    torch.cuda.reset_peak_memory_stats()
    mesh = launch_mesh.make_group_mesh(MESH_SHAPE, ("data", "model"),
                                       device_type="cuda")
    out = {"rank": ctx.process_id, "world": ctx.num_processes, "s": {}}

    def timed(name, fn):
        log.write(f"{name}\n")
        log.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out["s"].setdefault(name, []).append(time.perf_counter() - t0)
        return r

    # train: TRAIN_RULES, FSDP over data, sequence parallel
    spec = _mesh_spec(MESH_TRAIN_LAYERS)
    shape = shapes.Shape("train_mesh", MESH_TRAIN_SHAPE[1],
                         MESH_TRAIN_SHAPE[0], "train")
    bundle = steps.make_train_step(spec, shape, mesh)
    # each rank keeps its blocks of the params, and builds the AdamW
    # state on them: the full fp32 state would not fit four times
    p = bundle.place(steps.init_params(spec, seed=0, device=device), None,
                     None)[0]
    torch.cuda.empty_cache()
    o = bundle.place(None, _mesh_opt_at(adamw.init(p, per_agent=False),
                                        100), None)[1]
    metrics = []
    for i in range(MESH_TRAIN_STEPS):
        batch = _train_batch(spec, *MESH_TRAIN_SHAPE, i, device)
        b = bundle.place(None, None, batch)[2]
        p, o, m = timed("train", lambda: bundle.fn(p, o, b))
        metrics.append({k: float(v) for k, v in m.items()})
    out["train"] = metrics
    out["train_err"] = {k: _rel(metrics[0][k], refs["train"][k])
                        for k in ("loss", "grad_norm")}
    out["train_local_bytes"] = sum(x.to_local().numel()
                                   * x.to_local().element_size()
                                   for x in leaves((p, o))
                                   if hasattr(x, "to_local"))
    del p, o, bundle
    torch.cuda.empty_cache()
    # prefill with the flash kernel on each rank's heads
    spec = _mesh_spec(MESH_SERVE_LAYERS, use_flash=True)
    pshape = shapes.Shape("prefill_mesh", MESH_PREFILL[1], MESH_PREFILL[0],
                          "prefill")
    bundle = steps.make_prefill_step(spec, pshape, mesh)
    params = steps.init_params(spec, seed=0, device=device)
    tokens = refs["tokens"].to(device)
    p, b = bundle.place(params, {"tokens": tokens})
    reset_counts()
    logits = timed("prefill", lambda: bundle.fn(p, b))
    out["prefill_launches"] = launch_counts()
    logits = logits.full_tensor().float().cpu()
    out["prefill_err"] = _rel(logits, refs["prefill"])
    out["prefill_finite"] = bool(torch.isfinite(logits).all())
    del p, b, bundle
    # decode against a cache split along its sequence over model
    spec = _mesh_spec(MESH_SERVE_LAYERS)
    dshape = shapes.Shape("decode_mesh", MESH_DECODE_SLOTS, MESH_PREFILL[0],
                          "decode")
    for variant, sharded in (("sharded", True), ("decode_gathered", False)):
        sb = steps.make_serve_step(spec, dshape, mesh,
                                   sharded_softmax=sharded)
        caches = steps.build_caches(params, spec, dshape)
        p, _, c, _ = sb.place(params, None, caches, 0)
        del caches
        logs, coll = [], None
        for i in range(MESH_DECODE_STEPS):
            tok = sb.place(None, tokens[:, i:i + 1], None, 0)[1]
            if i == MESH_DECODE_STEPS - 1:
                counter = dryrun.LocalCounter()
                with counter:
                    lg, c = timed(variant, lambda: sb.fn(p, tok, c, i))
                coll = counter.collectives()
            else:
                lg, c = timed(variant, lambda: sb.fn(p, tok, c, i))
            logs.append(lg.full_tensor().float().cpu())
        out[variant] = {"err": _rel(torch.stack(logs), refs["decode"]),
                        "collectives": coll,
                        "cache_local_bytes": sum(
                            x.to_local().numel() * x.to_local().element_size()
                            for x in leaves(c) if x is not None)}
        del p, c, sb
    del params
    torch.cuda.empty_cache()
    # the DIALS-outer sync over (pod=2, data=1, model=2)
    pod_mesh = launch_mesh.make_group_mesh((2, 1, 2), ("pod", "data",
                                                       "model"),
                                           device_type="cuda")
    pod = pod_mesh.get_coordinate()[0]
    spec = _mesh_spec(f32=True)
    anchor = steps.init_params(spec, seed=0, device=device)
    local = [tree for tree in _pods(anchor, 2)][pod]
    out["outer_err"] = {}
    for kind in ("fp32", "int8"):
        cfg = outer.OuterConfig(compress_int8=kind == "int8")
        new, _, _ = timed(f"outer {kind}", lambda: outer.outer_step(
            local, outer.init(anchor), cfg, pod_axis="pod", mesh=pod_mesh))
        out["outer_err"][kind] = max(_rel(x.cpu(), y) for x, y in zip(
            leaves(new), refs["outer"][kind]))
    # reduced tinyllama in float32: one mesh train step
    shape = shapes.Shape("train_f32", 128, 4, "train")
    bundle = steps.make_train_step(spec, shape, mesh)
    opt = _mesh_opt_at(adamw.init(anchor, per_agent=False), 100)
    p, o, b = bundle.place(anchor, opt,
                           _train_batch(spec, 4, 128, 0, device))
    p, o, m = timed("train f32", lambda: bundle.fn(p, o, b))
    out["f32_err"] = {k: _rel(m[k], refs["f32"][k])
                      for k in ("loss", "grad_norm")}
    out["f32_err"]["params"] = max(
        _rel(x.full_tensor().cpu(), y)
        for x, y in zip(leaves(p), refs["f32"]["params"]))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def run_lm_mesh_path(device, smi):
    """The LM mesh (see MESH_RANKS): the single-device references on the
    card, then MESH_RANKS ranks spawned on cuda:0 over gloo, each held to
    them, and beside them the dry-run cell MESH_DRYRUN as a subprocess.
    Returns the ranks' launch counts, summed."""
    # the dry-run cell runs beside the ranks (it needs no card)
    arch, shape, mesh_kind = MESH_DRYRUN
    out_dir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    t_dry = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh_kind, "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    try:
        return _run_lm_mesh(device, smi, dry, t_dry, out_dir)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def _run_lm_mesh(device, smi, dry, t_dry, out_dir):
    """:func:`run_lm_mesh_path` with the dry-run subprocess started."""
    import torch
    from repro_torch.distributed import bootstrap
    t0 = time.perf_counter()
    refs = _mesh_references(device)
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    refs_path = os.path.join(ROOT, "build", "chip_smoke_mesh_refs.pt")
    os.makedirs(os.path.dirname(refs_path), exist_ok=True)
    torch.save(refs, refs_path)
    del refs
    t0 = time.perf_counter()
    try:
        ranks = bootstrap.spawn_local(MESH_RANKS, _mesh_rank, ROOT,
                                      refs_path, timeout_s=MESH_TIMEOUT_S)
    except RuntimeError:
        for r in range(MESH_RANKS):
            if os.path.exists(_mesh_rank_log(r)):
                with open(_mesh_rank_log(r)) as f:
                    print(f"--- {_mesh_rank_log(r)} ---\n"
                          f"{f.read()[-3000:]}", file=sys.stderr, flush=True)
        raise
    spawn_s = time.perf_counter() - t0
    label = f"lm mesh ({MESH_RANKS} ranks, data x model {MESH_SHAPE})"
    counts = {}
    for out in ranks:
        r = out["rank"]
        launches = out["prefill_launches"]
        for k, n in launches.items():
            counts[k] = counts.get(k, 0) + n
        secs = {k: [round(x, 3) for x in v] for k, v in out["s"].items()}
        print(f"{label} rank {r} on {smi}: seconds {secs}; train "
              f"{out['train']}; err train {out['train_err']}, prefill "
              f"{out['prefill_err']:.3e}, decode sharded "
              f"{out['sharded']['err']:.3e}, gathered "
              f"{out['decode_gathered']['err']:.3e}, outer "
              f"{out['outer_err']}, float32 {out['f32_err']}; flash "
              f"launches {launches.get('flash_fwd_sm90')}; peak "
              f"{out['peak_bytes']} bytes; train state "
              f"{out['train_local_bytes']} bytes, decode cache "
              f"{out['sharded']['cache_local_bytes']} bytes a rank; "
              f"staged collectives {out['staged']}", flush=True)
        for v in ("sharded", "decode_gathered"):
            print(f"{label} rank {r}: one decode step ({v}) collectives "
                  f"{json.dumps(out[v]['collectives'])}", flush=True)
        check(out["world"] == MESH_RANKS, f"{label}: world {out['world']}")
        for k, tol in (("loss", MESH_TOL["loss"]),
                       ("grad_norm", MESH_TOL["grad_norm"])):
            check(out["train_err"][k] <= tol,
                  f"{label} rank {r}: step-0 {k} off the single device by "
                  f"{out['train_err'][k]} (tol {tol})")
        check(all(math.isfinite(v) for m in out["train"] for v in m.values()),
              f"{label} rank {r}: a non-finite train metric")
        check(out["prefill_finite"] and out["prefill_err"]
              <= MESH_TOL["logits"],
              f"{label} rank {r}: prefill logits {out['prefill_err']}")
        check(launches.get("flash_fwd_sm90") == MESH_SERVE_LAYERS
              and launches.get("flash_attention") == MESH_SERVE_LAYERS,
              f"{label} rank {r}: flash launches {launches}, want "
              f"{MESH_SERVE_LAYERS} (one a self-attention layer)")
        for v in ("sharded", "decode_gathered"):
            check(out[v]["err"] <= MESH_TOL["logits"],
                  f"{label} rank {r}: decode ({v}) {out[v]['err']}")
        coll = out["sharded"]["collectives"]
        check(coll["counts"]["all-reduce"] > 0,
              f"{label} rank {r}: the sharded decode reduced nothing")
        check(out["sharded"]["collectives"]["total_bytes"]
              < out["decode_gathered"]["collectives"]["total_bytes"],
              f"{label} rank {r}: the distributed softmax moved no fewer "
              f"bytes than the gathered cache")
        for kind, e in out["outer_err"].items():
            check(e <= MESH_OUTER_TOL, f"{label} rank {r}: outer {kind} {e}")
        check(max(out["f32_err"].values()) <= MESH_F32_TOL,
              f"{label} rank {r}: float32 step {out['f32_err']}")
    arch, shape, mesh_kind = MESH_DRYRUN
    _, err = dry.communicate(timeout=600)
    dry_s = time.perf_counter() - t_dry
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__baseline"
                                 f".json")
    check(dry.returncode == 0 and os.path.exists(path),
          f"dry-run cell {MESH_DRYRUN} failed: {err[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    check(rec["status"] == "ok" and rec["n_devices"] == 256
          and rec["memory"]["argument_bytes"] > 0
          and rec["cost"]["flops"] > 0,
          f"dry-run cell {MESH_DRYRUN}: {rec}")
    print(f"dry-run {MESH_DRYRUN} (fake 256-rank group, fake CUDA tensors) "
          f"done {dry_s:.2f} s after its start, beside the ranks: memory "
          f"{json.dumps(rec['memory'])}; collectives "
          f"{json.dumps(rec['collectives'])}; flops/dev "
          f"{rec['cost']['flops']:.4e}; model flops "
          f"{rec['model_flops_global']:.4e}", flush=True)
    print(f"{label}: references {ref_s:.2f} s, spawn to finish "
          f"{spawn_s:.2f} s", flush=True)
    return counts


# the bench gate: torch_kernels --fast twice in process (A, then B), the
# gate on B against A and on a copy of B with BENCH_DEFECTS planted
BENCH_KERNELS = ("gru_forward", "gru_backward", "gae_forward", "gae_backward")
BENCH_DEFECTS = {"removed": 0, "null": ("gae", "speedup_fwd"),
                 "doubled": ("gru", "fwdbwd_kernel_s")}
BENCH_PATH = "bench gate and reports (torch_kernels --fast, twice)"


def _bench_gate(check_bench, fresh, baseline, max_regression,
                which="kernels"):
    """``torch_check_bench.check(which, ...)`` with its summary line
    captured: (problems, the line)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        problems = check_bench.check(which, fresh, baseline,
                                     max_regression=max_regression,
                                     subset=False)
    return problems, buf.getvalue().strip()


def check_planted_defects(check_bench, b_path, directory):
    """The gate (``torch_check_bench``) on a copy of the kernels record
    at ``b_path`` with BENCH_DEFECTS planted, against that record: micro
    row BENCH_DEFECTS["removed"] taken out, a cell of the first row of
    one kernel set to null and a time of the first remaining row of the
    other doubled. The gate's schema stage stops it at the null cell, so
    the copy must give exactly that finding; with the null cell put back,
    exactly the missing row and the doubled cell as a regression of 50 %.
    Returns the two runs' findings."""
    import copy
    with open(b_path) as f:
        b = json.load(f)
    spec = check_bench.SPECS["kernels"]
    broken = copy.deepcopy(b)
    gone = spec["key"](broken["micro"].pop(BENCH_DEFECTS["removed"]))
    (k_null, c_null), (k_dbl, c_dbl) = (BENCH_DEFECTS["null"],
                                        BENCH_DEFECTS["doubled"])
    nulled = next(r for r in broken["micro"] if r["kernel"] == k_null)
    doubled = next(r for r in broken["micro"] if r["kernel"] == k_dbl)
    was = nulled[c_null]
    check(was is not None and doubled[c_dbl] > 0,
          "bench gate: the cells to break are already broken")
    fresh = os.path.join(directory, "B_broken.json")

    def gate():
        with open(fresh, "w") as f:
            json.dump(broken, f)
        return _bench_gate(check_bench, fresh, b_path, 0.25)[0]

    nulled[c_null] = None
    doubled[c_dbl] *= 2
    found = [gate()]
    nulled[c_null] = was
    found.append(gate())
    key_null, key_dbl = spec["key"](nulled), spec["key"](doubled)
    want = [f"{key_null}: [kernels.micro] column {c_null!r} is null"]
    check(found[0] == want, f"bench gate on the broken copy: {found[0]}, "
                            f"want {want}")
    regressed = [p for p in found[1]
                 if p.startswith(f"{key_dbl}: {c_dbl} regressed 50% ")]
    check(len(found[1]) == 2 and len(regressed) == 1
          and f"{gone}: row missing from fresh artifact" in found[1],
          f"bench gate on the broken copy, its null cell put back: "
          f"{found[1]}")
    return found


def run_bench_gate_path(device, smi):
    """The port's bench gate and reports on the card, no JAX:
    ``benchmarks/torch_kernels.main(["--fast", ...])`` in process twice
    (A, then B; the wrappers count their launches), then
    ``benchmarks/torch_check_bench.check("kernels", B, A)``, which must
    find no structural problem (schema, row, column, null). B's timing
    cells against A's are printed as ratios, the spread within one call,
    and not gated: no bound is set before a benchmark of the port sets
    one. Every GRU and GAE kernel is held to its plain version at each
    shape the two runs launched it (``check_at_launched_shapes``). Then a
    copy of B with three planted defects (BENCH_DEFECTS: a
    row removed, a cell set to null, a ``*_kernel_s`` cell doubled)
    against B: the gate's schema stage stops it at the null cell, so the
    copy must give exactly that finding, and with the null cell put back
    exactly the missing row and the doubled cell as a regression of
    50 %. Last, ``benchmarks/torch_report``'s dry-run and roofline tables
    over the ``lm mesh path`` phase's dry-run record, whose roofline terms
    must equal ``torch_run.roofline_table``'s for that record. Returns
    the launch counts of the two bench runs (all, by shape) and the
    kernels' errors at those shapes."""
    import contextlib
    import io
    import shutil
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks import (torch_check_bench, torch_kernels, torch_report,
                            torch_run)
    d = os.path.join(ROOT, "build", "chip_smoke_bench")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    runs = {}
    reset_counts()
    for name in ("A", "B"):
        runs[name] = os.path.join(d, f"{name}.json")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = torch_kernels.main(["--fast", "--out", runs[name]])
        torch.cuda.synchronize()
        print(f"torch_kernels --fast ({name}) on {smi}: exit {rc}, "
              f"{time.perf_counter() - t0:.2f} s; "
              f"{buf.getvalue().strip().splitlines()[-1]}", flush=True)
        check(rc == 0, f"torch_kernels --fast ({name}) exited {rc}:\n"
                       f"{buf.getvalue()[-2000:]}")
    counts, by_shape = launch_counts(), shape_counts()
    print(f"bench gate: launches of the two runs {counts}", flush=True)
    for name in BENCH_KERNELS:
        check(counts[name] > 0, f"torch_kernels --fast never launched "
                                f"{name}")
    errs = check_at_launched_shapes(device, by_shape, "the two runs")

    problems, line = _bench_gate(torch_check_bench, runs["B"], runs["A"],
                                 math.inf)
    print(f"bench gate B against A: {line}; findings {problems}",
          flush=True)
    check(not problems, f"bench gate: structural findings in B against A "
                        f"{problems}")
    with open(runs["A"]) as f:
        a = json.load(f)
    with open(runs["B"]) as f:
        b = json.load(f)
    check(a["fast"] is True and b["fast"] is True,
          "torch_kernels --fast: the record's fast field is not true")
    spec = torch_check_bench.SPECS["kernels"]
    base = {spec["key"](r): r for r in spec["rows"](a)}
    ratios = {}
    for r in spec["rows"](b):
        k = spec["key"](r)
        ratios["/".join(k)] = {c: round(r[c] / base[k][c], 4)
                               for c in spec["times"] if c in r}
    flat = [v for cells in ratios.values() for v in cells.values()]
    print(f"bench gate: B/A time ratios (not gated), min {min(flat)}, max "
          f"{max(flat)}: {json.dumps(ratios)}", flush=True)

    found = check_planted_defects(torch_check_bench, runs["B"], d)
    print(f"bench gate on a copy of B with {len(BENCH_DEFECTS)} defects: "
          f"{found[0]}; with its null cell put back: {found[1]}",
          flush=True)

    arch, shape, mesh_kind = MESH_DRYRUN
    rec_name = f"{arch}__{shape}__{mesh_kind}__baseline.json"
    report_dir = os.path.join(d, "report")
    os.makedirs(os.path.join(report_dir, torch_report.RECORDS))
    shutil.copy(os.path.join(ROOT, "build", "chip_smoke_dryrun", rec_name),
                os.path.join(report_dir, torch_report.RECORDS, rec_name))
    tables = io.StringIO()
    with contextlib.chdir(report_dir):
        with contextlib.redirect_stdout(tables):
            torch_report.main(["--mesh", mesh_kind])
        recs = torch_report.load(mesh_kind)
        with contextlib.redirect_stdout(io.StringIO()):
            bench_rows = torch_run.roofline_table()
    print(tables.getvalue().strip(), flush=True)
    check(set(recs) == {(arch, shape)} and len(bench_rows) == 1,
          f"torch_report: records {sorted(recs)}, roofline rows "
          f"{len(bench_rows)}")
    terms, ratio = torch_report.roofline_row(recs[(arch, shape)])
    check(all(terms[k] == bench_rows[0][k] for k in terms),
          f"torch_report's roofline terms {terms} differ from torch_run's "
          f"{bench_rows[0]}")
    print(f"torch_report roofline terms of {MESH_DRYRUN} equal torch_run "
          f"--only roofline's: {json.dumps(terms)}; MODEL/HLO flops "
          f"{ratio}", flush=True)
    return counts, by_shape, errs


def check_at_launched_shapes(device, by_shape, runs):
    """Every GRU and GAE kernel against its plain version at each shape
    ``runs`` (the bench runs) launched it (``by_shape``, read before this
    call, so these launches are not counted): ``gru_case`` (forward,
    gradients at GRU_TOL, the backward twice for its bits) and
    ``gae_case`` (forward bit for bit, gradients at GAE_TOL). Returns
    {kernel: {"shapes": [...], "max_abs_err": worst}}."""
    import torch
    from repro_torch.marl.ppo import PPOConfig
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    ppo_cfg = PPOConfig()
    parse = lambda k: tuple(int(x) for x in k.split("x"))
    errs = {}

    def held(names, case):
        shapes = sorted({parse(k) for n in names for k in by_shape[n]})
        worst = [0.0, 0.0]
        for shape in shapes:
            fe, be = case(*shape)[:2]
            worst = [max(worst[0], fe), max(worst[1], be)]
        for name, e in zip(names, worst):
            errs[name] = {"shapes": ["x".join(map(str, x)) for x in shapes],
                          "max_abs_err": e}

    held(("gru_forward", "gru_backward"),
         lambda a, t, b, h: gru_case(gen, device, a, t, b, h))
    held(("gae_forward", "gae_backward"),
         lambda t, b: gae_case(gen, device, t, b, ppo_cfg.gamma,
                               ppo_cfg.lam))
    print(f"GRU and GAE kernels held to their plain versions at every "
          f"shape {runs} launched: {json.dumps(errs)}", flush=True)
    return errs


# the scaling bench into the gate: torch_scaling --fast once in process at
# traffic-2x2 (the reference's cell: FNN AIP and policy, so the GAE
# forward), its -s2-p2 row on two gloo ranks sharing the card; F cut
# from --fast's 4 to 1 (76.6 s for the phase at F=4 on one H100)
SCALING_ARGV = ("--fast", "--scenarios", "traffic-2x2", "--shards", "1,2",
                "--processes", "1,2", "--streams", "8", "--inner", "1")
SCALING_ROWS = ("traffic-2x2-s1", "traffic-2x2-s2-p2", "traffic-2x2-streams8")
SCALING_REMOVED = "traffic-2x2-s2-p2"
# the GAE forward's (T, B) on each -s2-p2 rank: 16 rollout steps, 8 envs
# x 2 of traffic-2x2's 4 agents (16x32 in process)
SCALING_RANK_SHAPE = "16x16"
SCALING_PATH = "scaling bench and gate (torch_scaling --fast, traffic-2x2)"


def run_scaling_gate_path(device, smi):
    """The port's scaling bench into its gate on the card, no JAX:
    ``benchmarks/torch_scaling.main`` with SCALING_ARGV in process once
    (the counts set to 0 just before it; the ranks of the ``-s2-p2`` row
    count in their own processes and return their counts in the record's
    ``spread``, which are added to this process's), whose rows must be
    exactly SCALING_ROWS, each a valid ``SCALING_ROW_SCHEMA`` row; the
    GAE forward launched in process and on every rank, at
    SCALING_RANK_SHAPE there, and each GRU and GAE kernel held to its
    plain version at every shape the sweep launched it. Then
    ``benchmarks/torch_check_bench.check("scaling", A, A)`` must find
    nothing, and a copy of A without the SCALING_REMOVED row exactly that
    row missing; every merged telemetry directory of the sweep passes
    ``tools/telemetry_report_torch.py --check``. Returns the sweep's
    launch counts (all, by shape) and the kernels' errors at those
    shapes."""
    import contextlib
    import io
    import shutil
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks import torch_check_bench, torch_scaling
    from repro_torch.obs import metrics as obs_metrics
    d = os.path.join(ROOT, "build", "chip_smoke_scaling")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    a_path, tel = os.path.join(d, "A.json"), os.path.join(d, "tel")
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = torch_scaling.main([*SCALING_ARGV, "--telemetry-dir", tel,
                                 "--out", a_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_shape = launch_counts(), shape_counts()
    out = buf.getvalue().splitlines()
    print("\n".join(line for line in out
                    if " round " in line or line.startswith("#")),
          flush=True)
    print(f"torch_scaling {' '.join(SCALING_ARGV)} on {smi}: exit {rc}, "
          f"{wall:.2f} s; launches in process {counts}; by shape "
          f"{by_shape}", flush=True)
    check(rc == 0, f"torch_scaling exited {rc}:\n{buf.getvalue()[-2000:]}")
    with open(a_path) as f:
        record = json.load(f)
    rows = record["rows"]
    check([r["label"] for r in rows] == list(SCALING_ROWS),
          f"torch_scaling rows {[r['label'] for r in rows]}, want "
          f"{list(SCALING_ROWS)}")
    for r in rows:
        problems = obs_metrics.validate_bench_row(
            r, obs_metrics.SCALING_ROW_SCHEMA)
        check(not problems, f"{r['label']}: {problems}")
        sp = record["spread"][r["label"]]
        print(f"scaling row {r['label']}: " + json.dumps(
            {k: r[k] for k in ("n_agents", "shards", "processes", "streams",
                               "fused", "round_s", "round_s_async",
                               "collect_s", "collect_s_sharded_gs",
                               "speedup_vs_unfused") if k in r})
            + f"; round_s serial {sp['serial']['round_s']}, async "
              f"{sp['async']['round_s']}", flush=True)
    check(counts["gae_forward"] > 0, "torch_scaling never launched "
                                     "gae_forward in process")
    for label, sp in record["spread"].items():
        for r, got in enumerate(sp.get("launches_by_rank", ())):
            print(f"scaling row {label} rank {r}: launches "
                  f"{got['launches']}; by shape {got['by_shape']}",
                  flush=True)
            check(got["launches"]["gae_forward"] > 0,
                  f"{label} rank {r} never launched gae_forward")
            for k, n in got["launches"].items():
                counts[k] += n
            for k, tbl in got["by_shape"].items():
                for shape, n in tbl.items():
                    by_shape[k][shape] = by_shape[k].get(shape, 0) + n
    check(len(record["spread"][SCALING_REMOVED].get("launches_by_rank", ()))
          == 2, f"{SCALING_REMOVED}: no launch counts from its two ranks")
    print(f"torch_scaling launches, in process and on the ranks: {counts}; "
          f"by shape {by_shape}", flush=True)
    errs = check_at_launched_shapes(device, by_shape, "the scaling sweep")
    check(SCALING_RANK_SHAPE in errs["gae_forward"]["shapes"],
          f"gae_forward not held at the ranks' shape {SCALING_RANK_SHAPE}: "
          f"{errs['gae_forward']['shapes']}")

    problems, line = _bench_gate(torch_check_bench, a_path, a_path,
                                 math.inf, "scaling")
    print(f"scaling gate A against A: {line}; findings {problems}",
          flush=True)
    check(not problems, f"scaling gate: findings in A against A {problems}")
    broken = dict(record, rows=[r for r in rows
                                if r["label"] != SCALING_REMOVED])
    b_path = os.path.join(d, "A_without_row.json")
    with open(b_path, "w") as f:
        json.dump(broken, f)
    found, line = _bench_gate(torch_check_bench, b_path, a_path, 0.25,
                              "scaling")
    want = [f"{SCALING_REMOVED}: row missing from fresh artifact"]
    print(f"scaling gate on A without {SCALING_REMOVED}: {line}; findings "
          f"{found}", flush=True)
    check(found == want, f"scaling gate on the broken copy: {found}, want "
                         f"{want}")
    merged = sorted(root for root, _dirs, files in os.walk(tel)
                    if "telemetry.jsonl" in files)
    check(len(merged) == 2 * len(SCALING_ROWS),
          f"merged telemetry directories {merged}")
    for directory in merged:
        _telemetry_report(directory)
    return counts, by_shape, errs


PHASES = ("gru/gae kernels vs plain", "flash kernel vs plain",
          "ssd kernel vs plain", "dials main path",
          "dials warehouse gru-policy path", "dials sharded path",
          "dials traffic path", "envs on the card",
          "checkpoint resume on the card", "dials async collect path",
          "dials fault path", "dials small input vs plain",
          "dials wide gru path", "experiment harness", "gae kernel vs plain at the harness shape",
          "contracts path", "gemma2-9b serving path",
          "lm architectures serving path", "mamba2 ssm layer path",
          "lm training path", "lm mesh path", "bench gate and reports",
          "scaling bench and gate")
# phases that read an earlier phase's results
NEEDS = {"dials sharded path": "dials warehouse gru-policy path",
         "bench gate and reports": "lm mesh path",
         "checkpoint resume on the card": "dials warehouse gru-policy path",
         "dials async collect path": "dials warehouse gru-policy path",
         "gae kernel vs plain at the harness shape":
             "gru/gae kernels vs plain"}


def selected(argv):
    """The phases to run: all of PHASES, or those ``--only a,b`` names
    (with the phases they read); the build and the kernel resources
    always run."""
    if "--only" not in argv:
        return set(PHASES)
    names = set(argv[argv.index("--only") + 1].split(","))
    unknown = names - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; "
                         f"choose from {list(PHASES)}")
    return names | {NEEDS[n] for n in names if n in NEEDS}


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
    run = selected(argv)
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
        rows = []
        if "gru/gae kernels vs plain" in run:
            rows += phase("gru/gae kernels vs plain", lambda: check_gru(
                gen, device, shapes) + check_gae(
                gen, device, 16, n_agents * 16, ppo_cfg.gamma, ppo_cfg.lam)
                + check_gru_wide(gen, device))
        if "flash kernel vs plain" in run:
            rows.append(phase("flash kernel vs plain", check_flash, gen,
                              device))
            rows[-1]["at_lm_shapes"] = phase(
                "flash kernel vs plain at the lm shapes",
                check_flash_at_lm_shapes, gen, device)
        if "ssd kernel vs plain" in run:
            rows.append(phase("ssd kernel vs plain", check_ssd, gen, device))
            rows.append(phase("ssd tiled kernel vs plain", check_ssd_tiled,
                              gen, device))
            rows.append(phase("ssd long-chunk kernel vs plain",
                              check_ssd_long, gen, device))
            rows.append(phase("ssd float32 long-chunk kernel vs plain",
                              check_ssd_f32_long, gen, device))
        for row in rows:
            print(f"kernel {row['name']}: max abs err "
                  f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.5f} "
                  f"ms by {row['bound'][1]}, library "
                  f"{row.get('library_ms')})", flush=True)

        # each path runs with every count set to 0 just before it and
        # read just after: path -> (counts, GRU counts by shape)
        paths = {}
        if "dials main path" in run:
            paths["dials warehouse fnn-policy"] = phase(
                "dials main path", run_main_path, device)
        if "dials warehouse gru-policy path" in run:
            *gru_path, state, history, streams = phase(
                "dials warehouse gru-policy path", run_gru_policy_path,
                device)
            paths["dials warehouse gru-policy"] = tuple(gru_path)
        if "dials sharded path" in run:
            *one_shard, rank_counts = phase(
                "dials sharded path", run_sharded_path, device, smi,
                history, state)
            paths["dials sharded (1 shard, in process)"] = tuple(one_shard)
            paths[f"dials sharded ({SHARDED_RANKS} ranks)"] = (
                {k: sum(c.get(k, 0) for c in rank_counts)
                 for k in rank_counts[0]}, {})
        if "dials traffic path" in run:
            paths["dials traffic"] = phase("dials traffic path",
                                           run_traffic_path, device)
        if "envs on the card" in run:
            paths["envs"] = phase("envs on the card", run_envs_on_card,
                                  device)
        if "checkpoint resume on the card" in run:
            paths["checkpoint resume"] = phase(
                "checkpoint resume on the card", run_resume_path, device,
                (state, history))
        if "dials async collect path" in run:
            paths["dials async collect"] = phase(
                "dials async collect path", run_async_path, device, smi,
                history, streams)
        if "dials warehouse gru-policy path" in run:
            del state, history
        if "dials fault path" in run:
            paths["dials fault path (two ranks on cuda:0)"] = phase(
                "dials fault path", run_fault_path, device, smi)
        if "dials small input vs plain" in run:
            phase("dials small input vs plain", check_small_against_plain,
                  device)
        if "dials wide gru path" in run:
            *wide, wide_errs = phase("dials wide gru path",
                                     run_wide_gru_path, device)
            paths["dials wide gru (warehouse side 2, hidden "
                  f"{'/'.join(map(str, WIDE_GRU_HIDDEN))})"] = tuple(wide)
            for r in rows:
                if wide_errs.get(r["name"], {}).get("shapes"):
                    r["at_wide_path_shapes"] = wide_errs[r["name"]]
                    r["max_abs_err"] = max(
                        r["max_abs_err"], wide_errs[r["name"]]["max_abs_err"])
        if "experiment harness" in run:
            paths["experiment harness (fig3 warehouse cell)"] = (phase(
                "experiment harness", run_harness_path, device), {})
        if "gae kernel vs plain at the harness shape" in run:
            # the GAE forward at the harness's shape: T=16, B=N*E=4*8
            next(r for r in rows if r["name"] == "gae_forward")[
                "at_harness_shape"] = phase(
                    "gae kernel vs plain at the harness shape",
                    check_gae_forward_at, gen, device, 16, 4 * 8,
                    ppo_cfg.gamma, ppo_cfg.lam)
        if "contracts path" in run:
            paths["contracts (walker, eager and capture calls; graph "
                  "replays uncounted)"] = phase("contracts path",
                                                run_contracts_path, device,
                                                smi)
        if "gemma2-9b serving path" in run:
            paths["gemma2-9b serving"] = (phase(
                "gemma2-9b serving path", run_serving_path, device), {})
        if "lm architectures serving path" in run:
            paths["lm architectures serving (8 archs, flash prefills)"] = (
                phase("lm architectures serving path", run_lm_archs_path,
                      device, smi), {})
        if "mamba2 ssm layer path" in run:
            paths["mamba2 ssm layer"] = (phase(
                "mamba2 ssm layer path", run_ssm_path, device), {})
        if "lm training path" in run:
            paths[LM_TRAIN_PATH] = (phase(
                "lm training path", run_lm_training_path, device, smi), {})
        if "lm mesh path" in run:
            paths[f"lm mesh ({MESH_RANKS} ranks on cuda:0, flash "
                  f"prefill)"] = (phase("lm mesh path", run_lm_mesh_path,
                                        device, smi), {})
        if "bench gate and reports" in run:
            *bench, bench_errs = phase("bench gate and reports",
                                       run_bench_gate_path, device, smi)
            paths[BENCH_PATH] = tuple(bench)
            for r in rows:
                if r["name"] in bench_errs:
                    r["at_bench_shapes"] = bench_errs[r["name"]]
                    r["max_abs_err"] = max(
                        r["max_abs_err"],
                        bench_errs[r["name"]]["max_abs_err"])
        if "scaling bench and gate" in run:
            *scaling, scaling_errs = phase("scaling bench and gate",
                                           run_scaling_gate_path, device,
                                           smi)
            paths[SCALING_PATH] = tuple(scaling)
            for r in rows:
                if scaling_errs.get(r["name"], {}).get("shapes"):
                    r["at_scaling_shapes"] = scaling_errs[r["name"]]
                    r["max_abs_err"] = max(
                        r["max_abs_err"],
                        scaling_errs[r["name"]]["max_abs_err"])
        if "flash kernel vs plain" in run:
            # the flash kernels at the other head_dims, after the paths
            rows += phase("flash kernels vs plain at other head_dims",
                          check_flash_ffma, gen, device)
            rows.append(phase("flash wide kernel vs plain", check_flash_wide,
                              gen, device))
        counts, by_shape, by_path = {}, {}, {}
        for path, (c, shapes_of) in paths.items():
            for k, n in c.items():
                counts[k] = counts.get(k, 0) + n
                if n or path == LM_TRAIN_PATH:
                    by_path.setdefault(k, {})[path] = n
            for k, tbl in shapes_of.items():
                merged = by_shape.setdefault(k, {})
                for shape, n in tbl.items():
                    merged[shape] = merged.get(shape, 0) + n
        if run == set(PHASES):
            for name in ("gru_forward", "gru_backward", "gae_forward",
                         "flash_attention", "ssd_intra_chunk",
                         "gru_forward_cluster", "gru_backward_cluster",
                         "flash_fwd_sm90_padded", "ssd_chunk_sm90_long",
                         "ssd_chunk_f32_long"):
                check(counts[name] > 0, f"its path never launched {name}")
        print(f"phases on {smi}: "
              f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}; "
              f"total {sum(phases.values()):.1f} s", flush=True)
    except Exception as exc:       # every phase failure ends the run
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        raise

    table = [{"name": r["name"], "route": r["route"], "source": r["source"],
              "replaces": r["replaces"], "launches": counts.get(r["name"], 0),
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1],
              "library_ms": r.get("library_ms"),
              **{k: r[k] for k in ("library", "shape", "ms_by_shape",
                                   "bound_ms_by_shape", "plain_ms_by_shape",
                                   "by_shape", "call_ms",
                                   "device_ms", "ms_by_route", "zamba2",
                                   "at_harness_shape", "at_lm_shapes",
                                   "at_bench_shapes", "at_scaling_shapes",
                                   "at_wide_path_shapes",
                                   "kernel_phase_launches")
                 if k in r},
              "launches_by_path": by_path.get(r["name"], {}),
              **({"launches_by_shape": by_shape[r["name"]]}
                 if r["name"] in by_shape else {})}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()},
        **({} if run == set(PHASES) else {"only": sorted(run)})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
