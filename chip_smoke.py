#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
     csrc`` and prints the build seconds;
  3. holds every kernel against its plain torch version on the card at
     the shapes the main path gives it (forward outputs and gradients
     within GRU 1e-5 and GAE 1e-6 times max(1, largest magnitude)) and
     times kernel and plain version with CUDA events;
  4. drives the main path — two DIALS loop rounds on warehouse side=10
     (100 agents) at the library's default widths with the GRU AIP,
     ``use_kernels="on"`` — with every launch count set to 0 just before
     and read just after, and checks every round record;
  5. checks the kernel path against the plain path on the card on a
     small input (one round, warehouse side=2);
  6. prints the kernel table as one JSON line, the nvidia-smi line, and
     as its last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line. Without CUDA, or
without the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# outside the tensor cores — the kernels compute in fp32 FFMA.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
GRU_TOL = 1e-5
GAE_TOL = 1e-6

# The slice's configuration: warehouse side=10, library default widths.
SIDE = 10
OUTER_ROUNDS = 2
AIP_REFRESH = 5


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


def bound_ms(nbytes: float, ops: float):
    """The least time of the card for this work, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def allclose_err(pairs, tol: float) -> float:
    """Max abs error over (name, kernel, plain) triples; raises unless
    every kernel output is finite and within tol * max(1, max |plain|)
    of the plain version (absolute at magnitudes <= 1, relative to the
    largest magnitude above: the gradients sum T*B terms)."""
    import torch
    worst = 0.0
    for name, k, p in pairs:
        err = max_err(k, p)
        scale = max(1.0, float(p.abs().max()))
        check(bool(torch.isfinite(k).all()) and err <= tol * scale,
              f"{name}: kernel disagrees with plain version "
              f"(max abs err {err:.3e}, allowed {tol} * {scale:.4g})")
        worst = max(worst, err)
    return worst


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


def check_gru(gen, device, shapes):
    """Forward at every main-path shape, forward+backward at the AIP
    training shape; returns the two kernel rows."""
    import torch
    from repro_torch.kernels.gru import kernel as gk, ref as gref
    fwd_err = 0.0
    for a, t, b, hdim in shapes["gru_forward"]:
        ins = gru_inputs(gen, a, t, b, hdim, device)
        fwd_err = max(fwd_err, allclose_err(
            [(f"gru_forward {a}x{t}x{b}x{hdim}", gk.forward(*ins),
              gref.gru_scan(*ins))], GRU_TOL))

    a, t, b, hdim = shapes["gru_backward"]
    gi, wh, bh, h0, resets = gru_inputs(gen, a, t, b, hdim, device)
    g = torch.randn(a, t, b, hdim, generator=gen, device=device)
    leaves = [x.clone().requires_grad_() for x in (gi, wh, bh, h0)]
    hs_k = gk.GRUScan.apply(*leaves, resets)
    grads_k = torch.autograd.grad(hs_k, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (gi, wh, bh, h0)]
    hs_p = gref.gru_scan(*ref_leaves, resets)
    grads_p = torch.autograd.grad(hs_p, ref_leaves, g, retain_graph=True)
    bwd_err = allclose_err(
        [(f"d{n}", k, p) for n, k, p in
         zip(("gi", "wh", "bh", "h0"), grads_k, grads_p)], GRU_TOL)

    fa, ft, fb, fh = shapes["gru_forward"][0]
    fins = gru_inputs(gen, fa, ft, fb, fh, device)
    hs = gk.forward(gi, wh, bh, h0, resets)
    iters = 20
    rows = []
    n = fa * ft * fb
    rows.append(dict(
        name="gru_forward", route="cuda",
        source="src/repro_torch/kernels/csrc/gru.cu",
        replaces="src/repro/kernels/gru/kernel.py:64",
        max_abs_err=fwd_err,
        ms=cuda_ms(lambda: gk.forward(*fins), iters),
        plain_ms=cuda_ms(lambda: gref.gru_scan(*fins), iters),
        bound=bound_ms(
            4.0 * (n * 3 * fh + fa * fh * 3 * fh + fa * 3 * fh
                   + fa * fb * fh + n + n * fh),
            n * (6.0 * fh * fh + 20.0 * fh))))
    n = a * t * b
    rows.append(dict(
        name="gru_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/gru.cu",
        replaces="src/repro/kernels/gru/kernel.py:132",
        max_abs_err=bwd_err,
        ms=cuda_ms(lambda: gk.backward(gi, wh, bh, h0, resets, hs, g),
                   iters),
        plain_ms=cuda_ms(lambda: torch.autograd.grad(
            hs_p, ref_leaves, g, retain_graph=True), iters),
        bound=bound_ms(
            4.0 * (2 * (n * 3 * hdim + a * hdim * 3 * hdim + a * 3 * hdim
                        + a * b * hdim) + n + 2 * n * hdim),
            n * (18.0 * hdim * hdim + 40.0 * hdim))))
    return rows


def check_gae(gen, device, t, b, gamma, lam):
    import torch
    from repro_torch.kernels.gae import kernel as ak, ref as aref
    r, v, nv = (torch.randn(t, b, generator=gen, device=device)
                for _ in range(3))
    d = (torch.rand(t, b, generator=gen, device=device) < 0.05).float()
    g = torch.randn(t, b, generator=gen, device=device)
    kw = dict(gamma=gamma, lam=lam)
    fwd_err = allclose_err(
        [("gae_forward", ak.forward(r, v, nv, d, gamma, lam),
          aref.gae_reverse_scan(r, v, nv, d, **kw))], GAE_TOL)
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
    return [
        dict(name="gae_forward", route="cuda",
             source="src/repro_torch/kernels/csrc/gae.cu",
             replaces="src/repro/kernels/gae/kernel.py:45",
             max_abs_err=fwd_err,
             ms=cuda_ms(lambda: ak.forward(r, v, nv, d, gamma, lam), iters),
             plain_ms=cuda_ms(
                 lambda: aref.gae_reverse_scan(r, v, nv, d, **kw), iters),
             bound=bound_ms(4.0 * 5 * n, 8.0 * n)),
        dict(name="gae_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/gae.cu",
             replaces="src/repro/kernels/gae/kernel.py:80",
             max_abs_err=bwd_err,
             ms=cuda_ms(lambda: ak.backward(g, d, gamma, lam), iters),
             plain_ms=cuda_ms(lambda: torch.autograd.grad(
                 adv_p, ref_leaves, g, retain_graph=True), iters),
             bound=bound_ms(4.0 * 4 * n, 6.0 * n)),
    ]


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def make_trainer(side, *, device, use_kernels, small=False, rounds=1,
                 refresh=1):
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    env_mod, env_cfg = registry.make("warehouse", side=side)
    info = env_cfg.info()
    if small:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions, hidden=(32,))
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru", hidden=(32,), gru_hidden=16,
                                 epochs=5)
        dc = dials.DIALSConfig(outer_rounds=rounds, aip_refresh=refresh,
                               collect_envs=4, collect_steps=32, n_envs=4,
                               rollout_steps=8, eval_episodes=2,
                               use_kernels=use_kernels)
    else:
        pc = policy.PolicyConfig(info.obs_dim, info.n_actions)
        ac = influence.AIPConfig(info.alsh_dim, info.n_influence,
                                 kind="gru")
        dc = dials.DIALSConfig(outer_rounds=rounds, aip_refresh=refresh,
                               use_kernels=use_kernels)
    return dials.DIALSTrainer(env_mod, env_cfg, pc, ac, ppo.PPOConfig(), dc,
                              device=device)


def launch_counts():
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    return {**gk.LAUNCHES, **ak.LAUNCHES}


def reset_counts():
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    for table in (gk.LAUNCHES, ak.LAUNCHES):
        for k in table:
            table[k] = 0


def run_main_path(device):
    import torch
    from repro_torch import random as R
    from repro_torch.obs import metrics as obs_metrics
    trainer = make_trainer(SIDE, device=device, use_kernels="on",
                           rounds=OUTER_ROUNDS, refresh=AIP_REFRESH)

    def log(rec):
        phases = {k: round(rec[k], 4) for k in
                  ("collect_s", "aip_s", "inner_s", "eval_s", "round_s")}
        print(f"main path round {rec['round']}: {phases} "
              f"gs_return={rec['gs_return']:.6f} "
              f"aip_ce {rec['aip_ce_before']:.6f}->"
              f"{rec['aip_ce_after']:.6f} "
              f"ials_reward={rec['ials_reward']:.6f} "
              f"launches so far={launch_counts()}", flush=True)

    reset_counts()
    t0 = time.perf_counter()
    state, history = trainer.run(R.key(0, device=device), log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"main path: {OUTER_ROUNDS} rounds in {wall:.3f} s, launches "
          f"{counts}", flush=True)

    check(len(history) == OUTER_ROUNDS, "main path: missing round records")
    for rec in history:
        check(set(rec) == set(obs_metrics.ROUND_KEYS),
              f"round {rec['round']}: fields differ from the round record")
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"round {rec['round']}: {k}={v}")
        check(rec["kernels"] == "policy=cuda,aip=cuda,ppo=cuda",
              f"kernel routing {rec['kernels']!r}")
    for leaf in (state["aips"]["gru"]["wh"], state["ials"]["obs"]):
        check(bool(torch.isfinite(leaf.float()).all()),
              "main path: non-finite state")
    n_agents = trainer.info.n_agents
    check(tuple(state["aips"]["gru"]["wh"].shape) == (n_agents, 64, 192),
          "main path: AIP GRU weights of the wrong shape")
    for name in ("gru_forward", "gru_backward", "gae_forward"):
        check(counts[name] > 0, f"main path never launched {name}")
    return counts


def check_small_against_plain(device):
    """One round at side=2 through the kernels and through the plain
    versions, on the card, from the same state."""
    import torch
    from repro_torch import random as R
    from repro_torch.tree import leaves
    out = {}
    for mode in ("on", "off"):
        trainer = make_trainer(2, device=device, use_kernels=mode,
                               small=True, rounds=1, refresh=2)
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
    # fp32 everywhere, as the reference: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    try:
        smi = smi_line()
        print(f"card: {smi}", flush=True)

        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.extension()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        from repro_torch.marl.ppo import PPOConfig
        ppo_cfg = PPOConfig()
        n_agents = SIDE * SIDE
        # main-path shapes: AIP training (S=7 train streams, T=128), held-
        # out eval_ce (S=1), the rollout cell (T=1, E=16), GAE over N*E
        shapes = {"gru_forward": [(n_agents, 128, 7, 64),
                                  (n_agents, 128, 1, 64),
                                  (n_agents, 1, 16, 64)],
                  "gru_backward": (n_agents, 128, 7, 64)}
        rows = check_gru(gen, device, shapes)
        rows += check_gae(gen, device, 16, n_agents * 16, ppo_cfg.gamma,
                          ppo_cfg.lam)
        for row in rows:
            print(f"kernel {row['name']}: max abs err "
                  f"{row['max_abs_err']:.3e}, {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.5f} "
                  f"ms by {row['bound'][1]})", flush=True)

        counts = run_main_path(device)
        check_small_against_plain(device)
    except Exception as exc:       # every phase failure ends the run
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        raise

    table = [{"name": r["name"], "route": r["route"], "source": r["source"],
              "replaces": r["replaces"], "launches": counts[r["name"]],
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1], "library_ms": None}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
