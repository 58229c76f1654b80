"""Where one DIALS round of the PyTorch/CUDA port spends its time on a GPU.

Runs the loop driver at ``chip_smoke.py``'s DIALS configuration (side=10,
default widths, GRU AIP, ``use_kernels="on"``, F=5; ``--env`` and
``--policy`` pick the scenario and the policy kind, warehouse and fnn by
default) for one round untraced, then the same round again under
``torch.profiler``, and prints:

* the untraced and the traced round's wall seconds and phase seconds
  (their difference is the profiler's cost);
* the device busy share: the union of all CUDA kernel intervals over the
  traced round's wall time (the rest is the device idle, waiting for the
  host to launch work);
* device time and launch count per kernel name, largest first.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_round_profile.py [--env traffic] [--policy gru]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

PHASES = ("collect_s", "aip_s", "inner_s", "eval_s", "round_s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="warehouse")
    ap.add_argument("--policy", default="fnn", choices=("fnn", "gru"))
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
    trainer = chip_smoke.make_trainer(
        args.env, chip_smoke.SIDE, device=device, use_kernels="on",
        rounds=1, refresh=chip_smoke.AIP_REFRESH, policy_kind=args.policy)
    _, (untraced,) = trainer.run(R.key(0, device=device))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, (traced,) = trainer.run(R.key(0, device=device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "env": args.env, "policy": args.policy,
        "untraced": {k: untraced[k] for k in PHASES},
        "traced": {k: traced[k] for k in PHASES},
        "traced_wall_s": wall,
        "device_kernels": len(intervals),
        "device_kernel_s": sum(ms for ms, _ in per_kernel.values()) / 1e3,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels": [{"name": name[:80], "ms": ms, "launches": n}
                        for name, (ms, n) in top],
    }
    for row in result["top_kernels"]:
        print(f"{row['ms']:10.3f} ms {row['launches']:7d}x  {row['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
