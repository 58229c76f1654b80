"""Kernel benchmark of the PyTorch/CUDA port: the plain torch versions
against the hand-written CUDA kernels on the DIALS hot spots — the port
of ``benchmarks/kernels.py``.

Micro rows (``repro_torch.obs.metrics.KERNELS_MICRO_SCHEMA``): the GRU
sequence (input projection + the scan kernel) and GAE, forward and
forward+backward, at the reference's shapes (``BENCH_kernels.json``'s
``micro`` rows): per scenario the AIP-training batch (collect_envs x
agents sequences of collect_steps, trunk width -> gru_hidden) and the PPO
batch (n_envs x agents chunks of rollout_steps), plus the headline shape,
the agent axis folded into the batch. Times are CUDA events over
``--iters`` calls after a warm-up call (seconds a call). Each row's
``roofline_*`` terms use the H100 SXM's published peaks (67 TFLOP/s fp32
outside the tensor cores, 3.35 TB/s HBM; ``chip_smoke.py``'s constants)
on the reference's analytic FLOP and byte counts; ``kernel_share`` is
the bound over the kernel's time.

``--fast`` is the reference's CI smoke (``benchmarks/kernels.py
--fast``): the same reduced shapes (collect_steps 16, rollout_steps 8, a
headline batch of 32; one AIP and two policy shapes and the headline),
2 timed calls a micro cell, the end-to-end cells at (S, T) = (8, 16) and
(n_envs, roll) = (2, 8) with one call each; the record's ``fast`` field
says which mode wrote it. ``benchmarks/torch_check_bench.py --which
kernels --subset`` reads it.

End-to-end rows (``KERNELS_E2E_SCHEMA``): one ``train_aip`` (GRU AIP,
gradients through the scan) and one IALS inner step (``ials_train``:
rollout + GAE + PPO with the GRU policy), ``use_kernels`` off against
on, host seconds a call ending in a synchronise.

Run from the root of a checkout on a machine with one NVIDIA GPU (it
exits non-zero without one: the plain versions on the host are no
measure of the card):

    python3 benchmarks/torch_kernels.py [--iters 10] [--fast]

Writes ``experiments/bench/BENCH_torch_kernels.json`` and
``name,metric,value`` lines on stdout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OUT_PATH = os.path.join(ROOT, "experiments", "bench",
                        "BENCH_torch_kernels.json")


def swept_shapes(fast: bool = False):
    """(label, B, T, in, H), as ``benchmarks/kernels.py`` sweeps them."""
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy
    dcfg = dials.DIALSConfig()
    acfg = influence.AIPConfig(in_dim=1, n_sources=1)
    pcfg = policy.PolicyConfig(obs_dim=1, n_actions=1)
    t_collect = 16 if fast else dcfg.collect_steps
    t_roll = 8 if fast else dcfg.rollout_steps
    shapes = []
    for name in registry.names():
        n = registry.make(name, side=2)[1].info().n_agents
        shapes.append((f"{name}-aip", dcfg.collect_envs * n, t_collect,
                       acfg.hidden[-1], acfg.gru_hidden))
        shapes.append((f"{name}-policy", dcfg.n_envs * n, t_roll,
                       pcfg.hidden[-1], pcfg.gru_hidden))
    shapes.append(("headline", 32 if fast else 256, t_collect,
                   pcfg.hidden[-1], pcfg.gru_hidden))
    if fast:            # one aip + two policy shapes + the headline
        shapes = shapes[:2] + shapes[3:4] + shapes[-1:]
    return shapes


def roofline(flops, nbytes, kernel_s):
    """The reference's roofline terms on the H100's peaks."""
    import chip_smoke
    compute_s = flops / chip_smoke.PEAK_FP32_PER_S
    memory_s = nbytes / chip_smoke.PEAK_BYTES_PER_S
    step_s = max(compute_s, memory_s)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": 0.0,
            "bottleneck": "compute" if compute_s >= memory_s else "memory",
            "step_s": step_s, "roofline_fraction": compute_s / step_s,
            "kernel_share": step_s / kernel_s}


def gru_footprint(b, t, din, h, *, backward):
    """``benchmarks/kernels.py``'s fp32 FLOPs and bytes of a GRU call."""
    inp = 2.0 * b * t * din * 3 * h
    rec = 2.0 * b * t * h * 3 * h
    elem = 12.0 * b * t * h
    flops = inp + rec + elem
    if backward:
        flops += 3 * rec + 2 * inp + 2 * elem
    nbytes = 4.0 * (b * t * din + din * 3 * h + 2 * b * t * 3 * h
                    + h * 3 * h + b * t * h)
    return flops, nbytes * (3 if backward else 1)


def gae_footprint(b, t, *, backward):
    k = 2.0 if backward else 1.0
    return 9.0 * b * t * k, 4.0 * 5 * b * t * k


def seconds(fn, iters):
    import chip_smoke
    return chip_smoke.cuda_ms(fn, iters) / 1e3


def micro_row(kernel, label, b, t, fns, iters, footprint, extra):
    """fns: {mode: (fwd, fwdbwd)} for mode "off" (plain) and "on"."""
    row = {"kernel": kernel, "label": label, "B": b, "T": t, **extra}
    for name, idx in (("fwd", 0), ("fwdbwd", 1)):
        row[f"{name}_oracle_s"] = seconds(fns["off"][idx], iters)
        row[f"{name}_kernel_s"] = seconds(fns["on"][idx], iters)
        row[f"speedup_{name}"] = row[f"{name}_oracle_s"] / \
            row[f"{name}_kernel_s"]
        row[f"roofline_{name}"] = roofline(
            *footprint(backward=idx == 1), row[f"{name}_kernel_s"])
    return row


def bench_gru(device, iters, fast=False):
    import torch
    from repro_torch import random as R
    from repro_torch.nn import gru as gru_mod
    rows = []
    for label, b, t, din, h in swept_shapes(fast):
        params = gru_mod.gru_init(R.split(R.key(0, device=device), 1),
                                  gru_mod.GRUConfig(in_dim=din, hidden=h))
        gen = torch.Generator(device=device).manual_seed(0)
        xs = torch.randn(1, b, t, din, generator=gen, device=device)
        resets = (torch.rand(1, b, t, generator=gen, device=device)
                  < 0.1).float()
        leaves = [params[k].requires_grad_() for k in ("wi", "wh", "bi",
                                                       "bh")]

        def fns(mode):
            seq = lambda: gru_mod.gru_sequence(
                params, xs, reset_mask=resets, use_kernels=mode)[0]

            @torch.no_grad()
            def fwd():
                return seq().sum()

            return fwd, lambda: torch.autograd.grad(seq().square().sum(),
                                                    leaves)

        rows.append(micro_row(
            "gru", label, b, t, {m: fns(m) for m in ("off", "on")}, iters,
            lambda backward: gru_footprint(b, t, din, h, backward=backward),
            {"in": din, "H": h}))
    return rows


def bench_gae(device, iters, fast=False):
    import torch
    from repro_torch.marl import gae as gae_mod
    rows = []
    # GAE runs on the PPO batch only: the -policy shapes and the headline
    shapes = [(lbl, b, t) for lbl, b, t, _, _ in swept_shapes(fast)
              if not lbl.endswith("-aip")]
    for label, b, t in shapes:
        gen = torch.Generator(device=device).manual_seed(1)
        rw = torch.randn(b, t, generator=gen, device=device)
        vl = torch.randn(b, t, generator=gen, device=device)
        dn = (torch.rand(b, t, generator=gen, device=device) < 0.1).float()
        lv = torch.randn(b, generator=gen, device=device)
        leaves = [rw.requires_grad_(), vl.requires_grad_()]

        def fns(mode):
            adv = lambda: gae_mod.gae(rw, vl, dn, lv, use_kernels=mode)[0]

            @torch.no_grad()
            def fwd():
                return adv().sum()

            return fwd, lambda: torch.autograd.grad(adv().square().sum(),
                                                    leaves)

        rows.append(micro_row(
            "gae", label, b, t, {m: fns(m) for m in ("off", "on")}, iters,
            lambda backward: gae_footprint(b, t, backward=backward), {}))
    return rows


def host_seconds(fn, iters):
    """Host seconds a call over ``iters`` back-to-back calls, after a
    warm-up call, from a synchronise to a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def bench_end_to_end(device, iters, fast=False):
    import torch
    from repro_torch import random as R
    from repro_torch.core import ials as ials_mod
    from repro_torch.core import influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    env_mod, env_cfg = registry.make("warehouse", side=2, horizon=32)
    info = env_cfg.info()
    rows = []

    # train_aip: one GRU AIP, gradients through the scan
    s, t = (8, 16) if fast else (32, 64)
    base_ac = influence.AIPConfig(
        in_dim=info.alsh_dim, n_sources=info.n_influence, kind="gru",
        hidden=(32,), gru_hidden=32, epochs=2 if fast else 10, batch=8)
    gen = torch.Generator(device=device).manual_seed(2)
    data = {"feats": torch.randn(1, s, t, info.alsh_dim, generator=gen,
                                 device=device),
            "u": (torch.rand(1, s, t, info.n_influence, generator=gen,
                             device=device) < 0.4).float(),
            "resets": (torch.rand(1, s, t, generator=gen,
                                  device=device) < 0.1).float()}
    params = influence.aip_init(R.split(R.key(2, device=device), 1), base_ac)
    times = {}
    for mode in ("off", "on"):
        ac = dataclasses.replace(base_ac, use_kernels=mode)
        times[mode] = host_seconds(lambda: influence.train_aip(
            params, data, R.split(R.key(3, device=device), 1), ac), iters)
    rows.append({"program": "train_aip", "label": f"warehouse-S{s}-T{t}",
                 "oracle_s": times["off"], "kernel_s": times["on"],
                 "speedup": times["off"] / times["on"]})

    # one IALS inner step: rollout + GAE + PPO, GRU policy
    pc_base = policy.PolicyConfig(obs_dim=info.obs_dim,
                                  n_actions=info.n_actions, kind="gru",
                                  hidden=(32,), gru_hidden=16)
    n_envs, roll = (2, 8) if fast else (8, 16)
    times = {}
    for mode in ("off", "on"):
        pc = dataclasses.replace(pc_base, use_kernels=mode)
        ac = dataclasses.replace(base_ac, use_kernels=mode)
        ppo_cfg = ppo.PPOConfig(epochs=1, minibatches=2, use_kernels=mode)
        init_fn, train_fn = ials_mod.make_ials_trainer(
            env_mod, env_cfg, pc, ac, ppo_cfg, n_envs=n_envs,
            rollout_steps=roll, device=device)
        state = init_fn(R.key(4, device=device))
        aips = influence.aip_init(
            R.split(R.key(5, device=device), info.n_agents), ac)
        times[mode] = host_seconds(lambda: train_fn(state, aips), iters)
    rows.append({"program": "ials_inner_step",
                 "label": f"warehouse-E{n_envs}-T{roll}",
                 "oracle_s": times["off"], "kernel_s": times["on"],
                 "speedup": times["off"] / times["on"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a micro cell (end to end: a third)")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's reduced shapes, 2 timed calls a "
                         "micro cell and 1 an end-to-end cell (CI smoke)")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    iters, e2e_iters = ((2, 1) if args.fast else
                        (args.iters, max(1, args.iters // 3)))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernels: CUDA is not available (the plain versions on "
              "the host are no measure of the card)", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build, dispatch
    from repro_torch.obs import metrics as obs_metrics
    device = dispatch.resolve_device("cuda:0")
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    build.extension()
    record = {"device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()},
              "card": card, "iters": iters, "fast": args.fast,
              "micro": bench_gru(device, iters, args.fast)
              + bench_gae(device, iters, args.fast),
              "end_to_end": bench_end_to_end(device, e2e_iters, args.fast)}
    problems = [p for r in record["micro"]
                for p in obs_metrics.validate_bench_row(
                    r, obs_metrics.KERNELS_MICRO_SCHEMA)]
    problems += [p for r in record["end_to_end"]
                 for p in obs_metrics.validate_bench_row(
                     r, obs_metrics.KERNELS_E2E_SCHEMA)]
    if problems:
        for p in problems:
            print(f"SCHEMA-INVALID {p}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print("name,metric,value")
    for r in record["micro"]:
        for k in ("fwd_oracle_s", "fwd_kernel_s", "fwdbwd_oracle_s",
                  "fwdbwd_kernel_s", "speedup_fwd", "speedup_fwdbwd"):
            print(f"torch_kernels.{r['kernel']}-{r['label']},{k},{r[k]}")
        for k in ("fwd", "fwdbwd"):
            print(f"torch_kernels.{r['kernel']}-{r['label']},"
                  f"bound_share_{k},{r[f'roofline_{k}']['kernel_share']}")
    for r in record["end_to_end"]:
        for k in ("oracle_s", "kernel_s", "speedup"):
            print(f"torch_kernels.{r['program']}-{r['label']},{k},{r[k]}")
    print(f"# wrote {args.out} ({record['device']['kind']}; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
