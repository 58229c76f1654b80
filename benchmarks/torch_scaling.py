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

``--shards 1,2`` adds the reference's sharded rows
(``benchmarks/scaling.py:109-188``) at the one ``--streams`` width,
labelled by its ``{scenario}-s{shards}[-p{processes}]`` rule:

* ``shards=1`` is the loop driver in this process, as above
  (``fused: false``, ``speedup_vs_unfused`` 1);
* ``shards=N>1`` runs the sharded round (``repro_torch.core.
  dials_sharded``) as N gloo ranks started by ``bootstrap.spawn_local``
  (one shard per process, all sharing ``cuda:0`` on a one-card machine),
  serial and with the dispatch-mode async collect, and rank 0's steady
  rounds make the row (``fused: true``, ``processes: N``,
  ``speedup_vs_unfused`` against the ``shards=1`` row); each rank also
  times one replicated collect of all agents (``collect_s``) and one
  region-decomposed collect of its block (``collect_s_sharded_gs``,
  rank 0's; null where the env cannot tile N blocks), ``gs_speedup``
  their ratio, each after a warm-up call.

The scenarios are the DIALS cells of ``PERF.md`` at side=10 (100 agents,
``chip_smoke.make_trainer``: the library's default widths, the GRU AIP,
``DIALSConfig()`` cut to ``--rounds`` rounds and F=``--inner``), kernels
on: warehouse with the FNN policy, warehouse with the recurrent policy,
traffic. Run from the root of a checkout on a machine with one NVIDIA
GPU:

    python3 benchmarks/torch_scaling.py [--scenarios warehouse-gru]
        [--streams 8,16] [--rounds 4] [--inner 5] [--telemetry-dir DIR]
        [--shards 1,2]

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
# seconds a sharded cell's ranks may take, serial and async runs together
RANK_TIMEOUT_S = 1800.0
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


def _trainer(scenario, streams, args, device, overlap, label,
             make_trainer=None, **kw):
    """The cell's trainer, built by ``make_trainer`` (default
    ``chip_smoke.make_trainer``: the cell's own widths)."""
    if make_trainer is None:
        import chip_smoke
        make_trainer = chip_smoke.make_trainer
    env, policy_kind = SCENARIOS[scenario]
    tel = (os.path.join(args.telemetry_dir,
                        f"{label}-{'async' if overlap else 'sync'}")
           if args.telemetry_dir else None)
    return make_trainer(
        env, args.side, device=device,
        use_kernels="on" if device.type == "cuda" else "off",
        rounds=args.rounds, refresh=args.inner,
        policy_kind=policy_kind, collect_streams=streams,
        async_collect=overlap, telemetry_dir=tel, **kw)


def _collect_s(collect, params, key, sync):
    """Seconds of one collect, after a warm-up call."""
    collect(params, key)
    sync()
    t0 = time.perf_counter()
    collect(params, key)
    sync()
    return time.perf_counter() - t0


def run_cell(scenario, streams, args, device, sync, label=None,
             make_trainer=None):
    from repro_torch import random as R
    label = label or f"{scenario}-streams{streams}"
    out = {}
    for overlap in (False, True):
        trainer = _trainer(scenario, streams, args, device, overlap, label,
                           make_trainer)
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
    collect_s = _collect_s(trainer.collect,
                           trainer.init(key)["ials"]["params"], key, sync)

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


def _sharded_rank(scenario, streams, args, device_name, label,
                  make_trainer):
    """One rank of a ``shards=world`` cell (started by
    ``bootstrap.spawn_local``): the sharded round serial, then with the
    dispatch-mode async collect, then the collect A/B. Returns plain
    values (rank 0's make the row)."""
    import torch
    from repro_torch import random as R
    from repro_torch.distributed import bootstrap, runtime
    from repro_torch.kernels import build, dispatch
    torch.set_num_threads(2)
    ctx = bootstrap.bootstrap()
    device = dispatch.resolve_device(device_name)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    if device.type == "cuda":
        build.extension()                  # built by the parent: a load
    out = {"rank": ctx.process_id}
    for overlap in (False, True):
        trainer = _trainer(scenario, streams, args, device, overlap, label,
                           make_trainer, shards=ctx.num_processes)
        key = R.key(args.seed, device=device)
        t0 = time.perf_counter()
        _, hist = trainer.run(key)
        sync()
        out["async" if overlap else "serial"] = (
            hist, time.perf_counter() - t0)
        if ctx.is_primary:
            for rec in hist:
                print(f"{label} {'async' if overlap else 'serial'} round "
                      f"{rec['round']} (rank 0 of {ctx.num_processes}): "
                      f"round_s={rec['round_s']:.4f} "
                      f"data_round={rec['data_round']} "
                      f"n_shards={rec['n_shards']}", flush=True)
    runner = trainer._sharded
    params = trainer.init(key)["ials"]["params"]
    out["collect_s"] = _collect_s(trainer.collect, params, key, sync)
    out["collect_s_sharded_gs"] = (
        _collect_s(runner.collect, runtime.shard_agent_tree(
            params, runner.mesh), key, sync)
        if runner.use_sharded_gs else None)
    out["n_agents"] = trainer.info.n_agents
    out["cfg"] = (trainer.cfg.aip_refresh, trainer.cfg.n_envs,
                  trainer.cfg.rollout_steps, trainer.cfg.collect_steps)
    return out


def run_sharded_cell(scenario, streams, shards, args, device,
                     unfused_round_s, make_trainer=None):
    """The ``shards``-rank row of ``scenario`` from its ranks' runs."""
    from repro_torch.distributed import bootstrap
    label = f"{scenario}-s{shards}-p{shards}"
    ranks = bootstrap.spawn_local(shards, _sharded_rank, scenario, streams,
                                  args, str(device), label, make_trainer,
                                  timeout_s=RANK_TIMEOUT_S)
    r0 = ranks[0]
    (h_sync, wall_sync), (h_async, wall_async) = r0["serial"], r0["async"]
    for r in ranks:
        if [h["round"] for h in r["serial"][0]] != \
                [h["round"] for h in h_sync]:
            raise RuntimeError(f"{label}: rank {r['rank']} ran other rounds")
    steady, steady_async = steady_round(h_sync), steady_round(h_async)
    refresh, n_envs, rollout_steps, collect_steps = r0["cfg"]
    n = r0["n_agents"]
    inner_steps = refresh * n_envs * rollout_steps * n
    sharded_s = r0["collect_s_sharded_gs"]
    row = {"label": label, "scenario": scenario, "n_agents": n,
           "shards": shards, "processes": shards, "streams": streams,
           "fused": True,
           "round_s": steady, "round_s_async": steady_async,
           "overlap_speedup": steady / steady_async,
           "inner_steps_per_s": inner_steps / steady,
           "inner_steps_per_s_async": inner_steps / steady_async,
           "total_wall_s": wall_sync, "total_wall_s_async": wall_async,
           "collect_s": r0["collect_s"],
           "env_steps_per_s": streams * collect_steps / r0["collect_s"],
           "collect_s_sharded_gs": sharded_s,
           "gs_speedup": (r0["collect_s"] / sharded_s
                          if sharded_s is not None else None),
           "speedup_vs_unfused": unfused_round_s / steady}
    return row, {"serial": spread(h_sync), "async": spread(h_async),
                 "data_round_async": [r["data_round"] for r in h_async],
                 "collect_s_by_rank": [r["collect_s"] for r in ranks],
                 "collect_s_sharded_gs_by_rank": [
                     r["collect_s_sharded_gs"] for r in ranks]}


def sharded_rows(scenario, streams, shard_counts, args, device, sync,
                 make_trainer=None):
    """``scenario``'s rows for ``shard_counts`` (the first is 1, the
    unfused baseline) with their spreads, as ``(row, spread)`` pairs."""
    unfused, sp = run_cell(scenario, streams, args, device, sync,
                           label=f"{scenario}-s1", make_trainer=make_trainer)
    out = [({**unfused, "speedup_vs_unfused": 1.0}, sp)]
    for shards in shard_counts[1:]:
        out.append(run_sharded_cell(scenario, streams, shards, args, device,
                                    unfused["round_s"], make_trainer))
    return out


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
    ap.add_argument("--shards", default=None,
                    help="comma-separated shard counts, e.g. 1,2: the "
                         "reference's sharded rows, one gloo rank per "
                         "shard (needs one --streams width)")
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
    shard_counts = (sorted({int(s) for s in args.shards.split(",")})
                    if args.shards else None)
    if shard_counts is not None:
        if len(streams_list) != 1:
            ap.error("--shards takes one --streams width")
        if shard_counts[0] != 1:
            ap.error("--shards must include 1 (the unfused baseline that "
                     "speedup_vs_unfused compares with)")

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

    def add(row, sp):
        rows.append(row)
        spreads[row["label"]] = sp

    for scenario in scenarios:
        if shard_counts is None:
            for streams in streams_list:
                add(*run_cell(scenario, streams, args, device, sync))
            continue
        for row, sp in sharded_rows(scenario, streams_list[0], shard_counts,
                                    args, device, sync):
            add(row, sp)
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
                         "shards": shard_counts,
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
