"""Where one DIALS round of the PyTorch/CUDA port spends its time on a GPU.

Runs the loop driver at ``chip_smoke.py``'s DIALS widths (side=10,
default widths, GRU AIP, ``use_kernels="on"``) at F=REFRESH; ``--env`` and
``--policy`` pick the scenario and the policy kind, warehouse and fnn by
default) for one round untraced, then the same round again under
``torch.profiler``, and prints:

* the untraced and the traced round's wall seconds and phase seconds
  (their difference is the profiler's cost);
* the device busy share: the union of all CUDA kernel intervals over the
  traced round's wall time (the rest is the device idle, waiting for the
  host to launch work);
* device time and launch count per kernel name, largest first (the
  driver's phase spans, which reach the trace as annotations, are left
  out);
* the host's ``cudaLaunchKernel`` calls: their count and mean duration
  (a launch path that two threads contend for shows here).

``--async-collect`` runs three rounds with the overlapped GS collect
(``async_collect=True``, ``max_aip_staleness=2``), untraced, then again
with the profiler (CUDA activity only) on round 1, a steady round: it
harvests round 0's collect and its own collect runs beside its AIP round
and inner steps. Besides the above it prints the device busy seconds of
each CUDA stream and the seconds in which kernels of the collect's
stream overlap kernels of the driver's stream (the stream of the GAE
kernel ``gae_fwd``, which only the inner steps launch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_round_profile.py [--env traffic] [--policy gru]
        [--async-collect]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# inner steps a round: the F of the profiles that PERF.md records
REFRESH = 5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

PHASES = ("collect_s", "aip_s", "inner_s", "eval_s", "round_s")


def union(intervals):
    """Sorted, disjoint (start, end) intervals covering ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def measure(merged) -> float:
    return sum(end - start for start, end in merged)


def intersection(a, b) -> float:
    """The length of the intersection of two unions of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(kernels):
    """Busy time by stream and the overlap of the collect's stream(s) with
    the driver's. ``kernels``: (name, stream, start_us, end_us)."""
    driver = {s for name, s, _, _ in kernels if "gae_fwd" in name}
    if len(driver) != 1:
        raise SystemExit(f"cannot tell the driver's stream: gae_fwd ran on "
                         f"{sorted(driver)}")
    driver = driver.pop()
    by_stream = {}
    for name, s, start, end in kernels:
        by_stream.setdefault(s, []).append((start, end))
    side = union([iv for s, ivs in by_stream.items() if s != driver
                  for iv in ivs])
    return {
        "driver_stream": driver,
        "streams": {str(s): {"kernels": len(ivs),
                             "busy_s": measure(union(ivs)) / 1e6}
                    for s, ivs in sorted(by_stream.items())},
        "side_kernels": sum(1 for _, s, _, _ in kernels if s != driver),
        "side_gru_fwd": sum(1 for name, s, _, _ in kernels
                            if s != driver and "gru_fwd" in name),
        "side_busy_s": measure(side) / 1e6,
        "overlap_s": intersection(union(by_stream[driver]), side) / 1e6,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="warehouse")
    ap.add_argument("--policy", default="fnn", choices=("fnn", "gru"))
    ap.add_argument("--async-collect", action="store_true",
                    help="profile a steady round of the overlapped collect")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch import random as R

    if not torch.cuda.is_available():
        print("torch_round_profile: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    from repro_torch.kernels import build
    build.extension()              # the build is no part of a round
    rounds = 3 if args.async_collect else 1
    async_kw = (dict(async_collect=True, max_aip_staleness=2)
                if args.async_collect else {})
    trainer = chip_smoke.make_trainer(
        args.env, chip_smoke.SIDE, device=device, use_kernels="on",
        rounds=rounds, refresh=REFRESH,
        policy_kind=args.policy, **async_kw)
    _, history = trainer.run(R.key(0, device=device))
    untraced = history[-1 if rounds == 1 else 1]

    if args.async_collect:
        # trace round 1 alone: start after round 0's record, stop after
        # round 1's (the device drained at both ends)
        prof = profile(activities=[ProfilerActivity.CUDA])
        mark = {}

        def log(rec):
            torch.cuda.synchronize()
            if rec["round"] == 0:
                prof.start()
                mark["t0"] = time.perf_counter()
            elif rec["round"] == 1:
                mark["wall"] = time.perf_counter() - mark["t0"]
                prof.stop()

        _, history = trainer.run(R.key(0, device=device), log=log)
        traced, wall = history[1], mark["wall"]
    else:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, (traced,) = trainer.run(R.key(0, device=device))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    intervals, per_kernel, kernels, launch_us = [], {}, [], []
    for ev in prof.events():
        if ev.is_user_annotation:
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name == "cudaLaunchKernel":
                launch_us.append(ev.time_range.elapsed_us())
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        kernels.append((ev.name, ev.device_resource_id, start, end))
        ms, n = per_kernel.get(ev.name, (0.0, 0))
        per_kernel[ev.name] = (ms + (end - start) / 1e3, n + 1)
    busy_us = measure(union(intervals))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "env": args.env, "policy": args.policy,
        "async_collect": args.async_collect,
        "untraced": {k: untraced[k] for k in PHASES},
        "traced": {k: traced[k] for k in PHASES},
        "data_round": [r["data_round"] for r in history],
        "traced_wall_s": wall,
        "device_kernels": len(intervals),
        "device_kernel_s": sum(ms for ms, _ in per_kernel.values()) / 1e3,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [{"name": name[:80], "ms": ms, "launches": n}
                        for name, (ms, n) in top],
        "launch_api": {"calls": len(launch_us),
                       "mean_us": sum(launch_us) / max(1, len(launch_us))},
    }
    if args.async_collect:
        result["streams"] = stream_overlap(kernels)
    for row in result["top_kernels"]:
        print(f"{row['ms']:10.3f} ms {row['launches']:7d}x  {row['name']}")
    print(f"{result['launch_api']['calls']} cudaLaunchKernel calls, mean "
          f"{result['launch_api']['mean_us']:.3f} us")
    if args.async_collect:
        st = result["streams"]
        for sid, row in st["streams"].items():
            who = "driver" if sid == str(st["driver_stream"]) else "collect"
            print(f"stream {sid} ({who}): {row['kernels']} kernels, busy "
                  f"{row['busy_s']:.6f} s")
        print(f"collect stream(s) busy {st['side_busy_s']:.6f} s, of which "
              f"{st['overlap_s']:.6f} s overlap the driver's kernels; "
              f"gru_fwd on the collect's stream: {st['side_gru_fwd']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
