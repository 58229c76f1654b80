"""DIALS round benchmark of the PyTorch/CUDA port: the loop driver with
the GS collect on the critical path against the overlapped collect — the
port of the loop-path rows of ``benchmarks/scaling.py``.

For each scenario and each collect stream width S (``--streams``) it runs
the loop driver twice from the same seed, serial and with
``async_collect=True`` (``max_aip_staleness=2``), and writes one row of
the reference's scaling schema
(``repro_torch.obs.metrics.SCALING_ROW_SCHEMA``; ``shards=1``,
``processes=1``, ``fused=false``, null sharded-GS columns):

* ``round_s`` / ``round_s_async``: the steady round, the mean over
  rounds 1.. (round 0 pays set-up and, async, the priming collect), from
  the records' ``wall_s``; ``overlap_speedup`` their ratio;
* ``inner_steps_per_s[_async]``: F * E * T * N agent-env steps a round
  over the steady round;
* ``total_wall_s[_async]``: the whole ``run()``, set-up included;
* ``collect_s`` and ``env_steps_per_s``: one collect of S streams timed
  alone after a warm-up call (``S * collect_steps / collect_s``).

Beside the rows (the schema admits no other column), ``spread`` keeps
each run's per-round ``round_s`` with the minimum, median and maximum of
its steady rounds: the run-to-run spread in one process.

The scenarios are the DIALS cells of ``PERF.md`` at side=10 (100 agents,
``chip_smoke.make_trainer``: the library's default widths, the GRU AIP,
``DIALSConfig()`` cut to ``--rounds`` rounds and F=``--inner``), kernels
on: warehouse with the FNN policy, warehouse with the recurrent policy,
traffic. Run from the root of a checkout on a machine with one NVIDIA
GPU:

    python3 benchmarks/torch_scaling.py [--scenarios warehouse-gru]
        [--streams 8,16] [--rounds 4] [--inner 5] [--telemetry-dir DIR]

It writes ``experiments/bench/BENCH_torch_dials_scaling.json`` and
``name,metric,value`` lines on stdout. ``--device cpu --side 2`` is a
rehearsal of the script on the host (plain versions; its times are the
CPU's and say nothing of the card).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OUT_PATH = os.path.join(ROOT, "experiments", "bench",
                        "BENCH_torch_dials_scaling.json")
# scenario -> (env, policy kind): the DIALS cells of PERF.md
SCENARIOS = {"warehouse-fnn": ("warehouse", "fnn"),
             "warehouse-gru": ("warehouse", "gru"),
             "traffic": ("traffic", "fnn")}


def spread(history):
    """Per-round ``round_s`` and the min/median/max of the steady rounds
    (1..; all rounds when there is one)."""
    times = [r["round_s"] for r in history]
    steady = times[1:] or times
    return {"round_s": times, "min": min(steady),
            "median": statistics.median(steady), "max": max(steady)}


def steady_round(history):
    """The reference's steady round: mean over rounds 1.., from wall_s."""
    if len(history) == 1:
        return history[0]["wall_s"]
    return (history[-1]["wall_s"] - history[0]["wall_s"]) / \
        (len(history) - 1)


def run_cell(scenario, streams, args, device, sync):
    import chip_smoke
    from repro_torch import random as R
    env, policy_kind = SCENARIOS[scenario]
    label = f"{scenario}-streams{streams}"
    use_kernels = "on" if device.type == "cuda" else "off"
    out = {}
    for overlap in (False, True):
        tel = (os.path.join(args.telemetry_dir,
                            f"{label}-{'async' if overlap else 'sync'}")
               if args.telemetry_dir else None)
        trainer = chip_smoke.make_trainer(
            env, args.side, device=device, use_kernels=use_kernels,
            rounds=args.rounds, refresh=args.inner, policy_kind=policy_kind,
            collect_streams=streams, async_collect=overlap,
            telemetry_dir=tel)
        key = R.key(args.seed, device=device)
        t0 = time.perf_counter()
        _, hist = trainer.run(key)
        sync()
        out[overlap] = (hist, time.perf_counter() - t0)
        for rec in hist:
            print(f"{label} {'async' if overlap else 'serial'} round "
                  f"{rec['round']}: round_s={rec['round_s']:.4f} "
                  f"collect_s={rec['collect_s']:.4f} aip_s={rec['aip_s']:.4f}"
                  f" inner_s={rec['inner_s']:.4f} eval_s={rec['eval_s']:.4f}"
                  f" data_round={rec['data_round']}", flush=True)
    # one collect of S streams alone, after a warm-up call
    params = trainer.init(key)["ials"]["params"]
    trainer.collect(params, key)
    sync()
    t0 = time.perf_counter()
    trainer.collect(params, key)
    sync()
    collect_s = time.perf_counter() - t0

    cfg, n = trainer.cfg, trainer.info.n_agents
    (h_sync, wall_sync), (h_async, wall_async) = out[False], out[True]
    steady, steady_async = steady_round(h_sync), steady_round(h_async)
    inner_steps = cfg.aip_refresh * cfg.n_envs * cfg.rollout_steps * n
    row = {"label": label, "scenario": scenario, "n_agents": n,
           "shards": 1, "processes": 1, "streams": streams, "fused": False,
           "round_s": steady, "round_s_async": steady_async,
           "overlap_speedup": steady / steady_async,
           "inner_steps_per_s": inner_steps / steady,
           "inner_steps_per_s_async": inner_steps / steady_async,
           "total_wall_s": wall_sync, "total_wall_s_async": wall_async,
           "collect_s": collect_s,
           "env_steps_per_s": streams * cfg.collect_steps / collect_s,
           "collect_s_sharded_gs": None, "gs_speedup": None}
    return row, {"serial": spread(h_sync), "async": spread(h_async),
                 "data_round_async": [r["data_round"] for r in h_async]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", default=",".join(SCENARIOS),
                    help=f"comma-separated, of {sorted(SCENARIOS)}")
    ap.add_argument("--streams", default="8",
                    help="comma-separated collect stream widths S")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--inner", type=int, default=5, help="F")
    ap.add_argument("--side", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--telemetry-dir", default=None,
                    help="one JSONL event-log directory per (cell, "
                         "serial/async) run under this directory")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args()
    scenarios = [s for s in args.scenarios.split(",") if s]
    unknown = set(scenarios) - set(SCENARIOS)
    if unknown:
        ap.error(f"unknown scenarios {sorted(unknown)}")
    if args.rounds < 2:
        ap.error("--rounds must be >= 2 (round 0 is not steady)")
    streams_list = sorted({int(s) for s in args.streams.split(",")})

    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.obs import metrics as obs_metrics
    device = dispatch.resolve_device(args.device)   # raises without a card
    if device.type == "cuda":
        import chip_smoke
        from repro_torch.kernels import build
        card = chip_smoke.smi_line()
        print(f"card: {card}", flush=True)
        build.extension()
        sync = torch.cuda.synchronize
        kind = torch.cuda.get_device_name(0)
        platform, count = "gpu", torch.cuda.device_count()
    else:
        card, sync, kind, platform, count = None, lambda: None, "cpu", \
            "cpu", 1

    rows, spreads = [], {}
    for scenario in scenarios:
        for streams in streams_list:
            row, sp = run_cell(scenario, streams, args, device, sync)
            rows.append(row)
            spreads[row["label"]] = sp
    problems = [p for r in rows for p in obs_metrics.validate_bench_row(
        r, obs_metrics.SCALING_ROW_SCHEMA)]
    if problems:
        for p in problems:
            print(f"SCHEMA-INVALID {p}", file=sys.stderr)
        return 1
    record = {"device": {"platform": platform, "kind": kind,
                         "count": count},
              "card": card,
              "config": {"side": args.side, "rounds": args.rounds,
                         "inner": args.inner, "seed": args.seed,
                         "max_aip_staleness": 2},
              "rows": rows, "spread": spreads}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print("name,metric,value")
    for r in rows:
        for k, v in r.items():
            if k not in ("label", "scenario"):
                print(f"torch_dials_scaling.{r['label']},{k},{v}")
    for label, sp in spreads.items():
        for mode in ("serial", "async"):
            print(f"torch_dials_scaling.{label},round_s_{mode}_spread,"
                  f"{sp[mode]['min']}/{sp[mode]['median']}/"
                  f"{sp[mode]['max']}")
    print(f"# wrote {args.out} ({kind}; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
