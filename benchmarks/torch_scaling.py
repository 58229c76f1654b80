"""DIALS scaling benchmark of the PyTorch/CUDA port — shard count ×
scenario sweep, the port of ``benchmarks/scaling.py`` over the port's
modules, importing nothing of the JAX package.

For every (scenario, shard count) cell it runs the DIALS driver twice
from the same seed, serial and with ``async_collect=True``
(``max_aip_staleness=2``), and writes one row of the reference's scaling
schema (``repro_torch.obs.metrics.SCALING_ROW_SCHEMA``), labelled by the
reference's ``{scenario}-s{shards}[-p{processes}]`` rule:

* ``{scenario}-s1`` is the loop driver in this process (``fused:
  false``, ``speedup_vs_unfused`` 1);
* ``{scenario}-sN-pN`` (N > 1) runs the sharded round
  (``repro_torch.core.dials_sharded``) as N gloo ranks started by
  ``bootstrap.spawn_local`` (one shard per process, all sharing
  ``cuda:0`` on a one-card machine), and rank 0's steady rounds make the
  row (``fused: true``, ``speedup_vs_unfused`` against the ``-s1`` row
  when it ran); each rank also times one replicated collect of all
  agents (``collect_s``) and one region-decomposed collect of its block
  (``collect_s_sharded_gs``, rank 0's; null where the env cannot tile N
  blocks), ``gs_speedup`` their ratio.

The shard rows run at the cell's collect width (an empty ``--shards``
runs none). ``--streams S1,S2,...`` adds the reference's large-batch
rows on the FIRST scenario, ``{scenario}-streams{S}``: the loop driver
at collect width S. A row's columns:

* ``round_s`` / ``round_s_async``: the steady round, the mean over
  rounds 1.. (round 0 pays set-up and, async, the priming collect; with
  one round, that round), from the records' ``wall_s``;
  ``overlap_speedup`` their ratio;
* ``inner_steps_per_s[_async]``: F * E * T * N agent-env steps a round
  over the steady round;
* ``total_wall_s[_async]``: the whole ``run()``, set-up included;
* ``collect_s`` and ``env_steps_per_s``: one collect timed alone after a
  warm-up call (``S * collect_steps / collect_s``).

Beside the rows (the schema admits no other column), ``spread`` keeps
each run's per-round ``round_s`` with the minimum, median and maximum of
its steady rounds: the run-to-run spread in one process; a sharded row's
also keeps each rank's ``collect_s`` and its kernel launches
(``launches_by_rank``: all, and by shape), which the parent's counts do
not see.

Scenarios: every name of ``repro_torch.launch.variants.MARL_SCENARIOS``
is the reference's cell (``benchmarks/scaling.py:148-152``:
``torch_run._setup``'s widths, FNN AIP and policy,
:func:`reference_cell`); the default is the reference's grid. The DIALS
cells of ``PERF.md`` are extra names (``SCENARIOS``): side ``--side``
(default 10, 100 agents), ``chip_smoke.make_trainer``'s widths, the GRU
AIP. Without ``--fast`` a reference cell runs 4 rounds of F=20 and 64
collect steps, a side-10 cell 4 rounds of F=5 and ``DIALSConfig``'s
collect steps; ``--fast`` (the reference's CI smoke) runs 2 rounds of
F=4 and 32 collect steps; ``--rounds`` and ``--inner`` win over both.

``--processes P1,P2,...`` keeps the rows whose process count is listed:
the port runs one shard per process, so ``-sN-pN`` runs at P=N, and
``-s1`` and the stream rows at P=1. Every other cell prints a ``# skip``
line; a list that leaves no row exits 2. ``--profile-dir`` wraps the
sweep in ``repro_torch.obs.trace.profile`` (the spawned ranks do not
profile); ``--telemetry-dir`` gives each (cell, sync/async) run its own
event-log directory and merges each afterwards. Kernels are on on the
card. Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_scaling.py [--fast] [--shards 1,2,4,8,16]
        [--scenarios traffic-2x2,powergrid-ring16] [--processes 1,2]
        [--streams 8,64,512] [--rounds R] [--inner F]
        [--telemetry-dir DIR] [--profile-dir DIR]

It writes ``experiments/bench/BENCH_torch_dials_scaling.json`` (the
gate, ``benchmarks/torch_check_bench.py --which scaling``, reads it) and
``name,metric,value`` lines on stdout. ``--device cpu`` is a rehearsal
on the host (plain versions; its times are the CPU's and say nothing of
the card).
"""
from __future__ import annotations

import argparse
import dataclasses
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
# scenario -> (env, policy kind): the side-10 DIALS cells of PERF.md
SCENARIOS = {"warehouse-fnn": ("warehouse", "fnn"),
             "warehouse-gru": ("warehouse", "gru"),
             "traffic": ("traffic", "fnn")}
# the reference's default grid (benchmarks/scaling.py:293-303)
DEFAULT_SCENARIOS = ("traffic-2x2", "supplychain-line4", "powergrid-ring16",
                     "supplychain-line16")
# (rounds, F, collect steps): --fast, the reference's cells, the side-10
# cells (None: DIALSConfig's collect steps)
FAST_SIZES = (2, 4, 32)
REFERENCE_SIZES = (4, 20, 64)
SIDE10_SIZES = (4, 5, None)
PROCESS_RULE = ("the port runs one shard per process (P = the shard "
                "count; -s1 and the stream rows at P=1)")


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


def cell_sizes(scenario, args):
    """(rounds, F, collect steps or None) of ``scenario``'s runs."""
    rounds, inner, collect_steps = (
        FAST_SIZES if args.fast else
        SIDE10_SIZES if scenario in SCENARIOS else REFERENCE_SIZES)
    return (rounds if args.rounds is None else args.rounds,
            inner if args.inner is None else args.inner, collect_steps)


def reference_cell(rounds, inner, collect_steps, shards, overlap,
                   streams=None, telemetry_dir=None):
    """The reference's scaling cell (``benchmarks/scaling.py:148-152``,
    and ``:225-230`` with ``streams``)."""
    from repro_torch.core import dials
    from repro_torch.launch import variants
    return dials.DIALSConfig(
        outer_rounds=rounds, aip_refresh=inner, collect_envs=4,
        collect_steps=collect_steps, n_envs=8, rollout_steps=16,
        eval_episodes=4, telemetry_dir=telemetry_dir,
        **variants.dials_variant_for(shards, overlap, streams=streams))


def n_agents(scenario, side):
    from repro_torch.envs import registry
    from repro_torch.launch import variants
    if scenario in SCENARIOS:
        env, cell_side = SCENARIOS[scenario][0], side
    else:
        env, cell_side = variants.MARL_SCENARIOS[scenario]
    return registry.make(env, side=cell_side)[1].info().n_agents


def _trainer(scenario, args, device, overlap, label, *, streams=None,
             shards=1, make_trainer=None):
    """The cell's trainer: ``make_trainer`` (default
    ``chip_smoke.make_trainer``) for a side-10 name, the reference's cell
    otherwise."""
    from repro_torch.launch import variants
    rounds, inner, collect_steps = cell_sizes(scenario, args)
    tel = (os.path.join(args.telemetry_dir,
                        f"{label}-{'async' if overlap else 'sync'}")
           if args.telemetry_dir else None)
    use_kernels = "on" if device.type == "cuda" else "off"
    if scenario in SCENARIOS:
        if make_trainer is None:
            import chip_smoke
            make_trainer = chip_smoke.make_trainer
        env, policy_kind = SCENARIOS[scenario]
        steps = {} if collect_steps is None else \
            {"collect_steps": collect_steps}
        return make_trainer(
            env, args.side, device=device, use_kernels=use_kernels,
            rounds=rounds, refresh=inner, policy_kind=policy_kind,
            telemetry_dir=tel, **steps,
            **variants.dials_variant_for(shards, overlap, streams=streams))
    from benchmarks.torch_run import _setup
    from repro_torch.core import dials
    env_mod, env_cfg, _info, pc, ac, ppo_cfg = _setup(
        *variants.MARL_SCENARIOS[scenario])
    cfg = reference_cell(rounds, inner, collect_steps, shards, overlap,
                         streams, tel)
    return dials.DIALSTrainer(
        env_mod, env_cfg, pc, ac, ppo_cfg,
        dataclasses.replace(cfg, use_kernels=use_kernels), device=device)


def _collect_s(collect, params, key, sync):
    """Seconds of one collect, after a warm-up call."""
    collect(params, key)
    sync()
    t0 = time.perf_counter()
    collect(params, key)
    sync()
    return time.perf_counter() - t0


def _row(label, scenario, n, shards, streams, runs, cfg, collect_s,
         sharded_s=None):
    """A scaling row from the serial and async runs' (history, wall)."""
    from repro_torch.core import dials
    (h_sync, wall_sync), (h_async, wall_async) = runs
    steady, steady_async = steady_round(h_sync), steady_round(h_async)
    inner_steps = cfg.aip_refresh * cfg.n_envs * cfg.rollout_steps * n
    streams = dials.collect_stream_count(cfg) if streams is None else streams
    row = {"label": label, "scenario": scenario, "n_agents": n,
           "shards": shards, "processes": shards, "streams": streams,
           "fused": shards > 1,
           "round_s": steady, "round_s_async": steady_async,
           "overlap_speedup": steady / steady_async,
           "inner_steps_per_s": inner_steps / steady,
           "inner_steps_per_s_async": inner_steps / steady_async,
           "total_wall_s": wall_sync, "total_wall_s_async": wall_async,
           "collect_s": collect_s,
           "env_steps_per_s": streams * cfg.collect_steps / collect_s,
           "collect_s_sharded_gs": sharded_s,
           "gs_speedup": (collect_s / sharded_s
                          if sharded_s is not None else None)}
    return row, {"serial": spread(h_sync), "async": spread(h_async),
                 "data_round_async": [r["data_round"] for r in h_async]}


def run_cell(scenario, args, device, sync, *, label, streams=None,
             make_trainer=None):
    """The loop driver's row of one cell, in this process, at collect
    width ``streams`` (None: the cell's own)."""
    from repro_torch import random as R
    out = []
    for overlap in (False, True):
        trainer = _trainer(scenario, args, device, overlap, label,
                           streams=streams, make_trainer=make_trainer)
        key = R.key(args.seed, device=device)
        t0 = time.perf_counter()
        _, hist = trainer.run(key)
        sync()
        out.append((hist, time.perf_counter() - t0))
        for rec in hist:
            print(f"{label} {'async' if overlap else 'serial'} round "
                  f"{rec['round']}: round_s={rec['round_s']:.4f} "
                  f"collect_s={rec['collect_s']:.4f} aip_s={rec['aip_s']:.4f}"
                  f" inner_s={rec['inner_s']:.4f} eval_s={rec['eval_s']:.4f}"
                  f" data_round={rec['data_round']}", flush=True)
    collect_s = _collect_s(trainer.collect,
                           trainer.init(key)["ials"]["params"], key, sync)
    return _row(label, scenario, trainer.info.n_agents, 1, streams, out,
                trainer.cfg, collect_s)


def kernel_launches():
    """This process's GRU and GAE kernel launches: ``{name: n}`` and
    ``{name: {shape: n}}`` (GRU by ``AxTxBxH``, GAE by ``TxB``)."""
    from repro_torch.kernels.gae import kernel as ak
    from repro_torch.kernels.gru import kernel as gk
    tables = {**gk.SHAPE_LAUNCHES, **ak.SHAPE_LAUNCHES}
    return ({**gk.LAUNCHES, **ak.LAUNCHES},
            {name: {"x".join(map(str, k)): n for k, n in sorted(tbl.items())}
             for name, tbl in tables.items()})


def _sharded_rank(scenario, args, device_name, label, make_trainer):
    """One rank of a ``shards=world`` cell (started by
    ``bootstrap.spawn_local``): the sharded round serial, then with the
    dispatch-mode async collect, then the collect A/B. Returns plain
    values (rank 0's make the row) and the rank's kernel launches."""
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
        trainer = _trainer(scenario, args, device, overlap, label,
                           shards=ctx.num_processes,
                           make_trainer=make_trainer)
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
    out["cfg"] = trainer.cfg
    launches, by_shape = kernel_launches()
    out["launches"] = {"launches": launches, "by_shape": by_shape}
    return out


def run_sharded_cell(scenario, shards, args, device, unfused_round_s,
                     make_trainer=None):
    """The ``shards``-rank row of ``scenario`` from its ranks' runs, with
    ``speedup_vs_unfused`` when ``unfused_round_s`` (the ``-s1`` row's
    steady round) is given."""
    from repro_torch.distributed import bootstrap
    label = f"{scenario}-s{shards}-p{shards}"
    ranks = bootstrap.spawn_local(shards, _sharded_rank, scenario, args,
                                  str(device), label, make_trainer,
                                  timeout_s=RANK_TIMEOUT_S)
    r0 = ranks[0]
    for r in ranks:
        if [h["round"] for h in r["serial"][0]] != \
                [h["round"] for h in r0["serial"][0]]:
            raise RuntimeError(f"{label}: rank {r['rank']} ran other rounds")
    row, sp = _row(label, scenario, r0["n_agents"], shards, None,
                   (r0["serial"], r0["async"]), r0["cfg"], r0["collect_s"],
                   r0["collect_s_sharded_gs"])
    if unfused_round_s is not None:
        row["speedup_vs_unfused"] = unfused_round_s / row["round_s"]
    sp["collect_s_by_rank"] = [r["collect_s"] for r in ranks]
    sp["collect_s_sharded_gs_by_rank"] = [r["collect_s_sharded_gs"]
                                          for r in ranks]
    sp["launches_by_rank"] = [r["launches"] for r in ranks]
    return row, sp


def sharded_rows(scenario, shard_counts, args, device, sync,
                 make_trainer=None):
    """``scenario``'s shard rows for ``shard_counts`` (1: the loop path
    in this process; N > 1: N ranks) with their spreads, as ``(row,
    spread)`` pairs."""
    out, unfused = [], None
    for shards in shard_counts:
        if shards == 1:
            row, sp = run_cell(scenario, args, device, sync,
                               label=f"{scenario}-s1",
                               make_trainer=make_trainer)
            unfused = row["round_s"]
            out.append(({**row, "speedup_vs_unfused": 1.0}, sp))
        else:
            out.append(run_sharded_cell(scenario, shards, args, device,
                                        unfused, make_trainer))
    return out


def plan(scenarios, shard_counts, processes, streams_list, side):
    """The cells to run, ``{scenario: [shard count, ...]}``, and the
    stream widths, after printing the reference's ``# skip`` lines for
    counts that do not divide a scenario's agents and the port's for
    process counts ``processes`` (None: all) does not list."""
    cells = {}
    for scenario in scenarios:
        n = n_agents(scenario, side)
        cells[scenario] = []
        for shards in shard_counts:
            if n % shards:
                print(f"# skip {scenario} shards={shards}: "
                      f"{n} agents not divisible")
            elif processes is not None and shards not in processes:
                print(f"# skip {scenario} shards={shards}: the port runs "
                      f"one shard per process (P={shards})")
            else:
                cells[scenario].append(shards)
    if streams_list and processes is not None and 1 not in processes:
        print(f"# skip {scenarios[0]} streams={streams_list}: the stream "
              f"rows run in one process (P=1)")
        streams_list = []
    return cells, streams_list


def merge_telemetry(directory) -> int:
    """Merge every cell directory under ``directory`` that holds
    ``telemetry-p*.jsonl`` (``repro_torch.obs.sinks.merge_dir``); returns
    their number."""
    from repro_torch.obs import sinks
    merged = 0
    for root, _dirs, files in sorted(os.walk(directory)):
        if any(f.startswith("telemetry-p") and f.endswith(".jsonl")
               for f in files):
            sinks.merge_dir(root)
            merged += 1
    return merged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the reference's CI smoke: 2 rounds of F=4, 32 "
                         "collect steps")
    ap.add_argument("--shards", default="1,2,4,8,16",
                    help="comma-separated shard counts (1 = the loop "
                         "path; empty: no shard rows); counts that do not "
                         "divide a scenario's agent count are skipped")
    ap.add_argument("--scenarios", default=",".join(DEFAULT_SCENARIOS),
                    help="comma-separated names of launch.variants."
                         f"MARL_SCENARIOS, or of {sorted(SCENARIOS)}")
    ap.add_argument("--streams", default=None,
                    help="comma-separated collect stream widths S: one "
                         "loop-path row per S on the FIRST scenario, "
                         "labelled {scenario}-streams{S}")
    ap.add_argument("--processes", default=None,
                    help="comma-separated process counts: keep the rows "
                         "that run at a listed P (-sN-pN at P=N, -s1 and "
                         "the stream rows at P=1)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--inner", type=int, default=None, help="F")
    ap.add_argument("--side", type=int, default=10,
                    help=f"side of the {sorted(SCENARIOS)} cells")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--telemetry-dir", default=None,
                    help="one JSONL event-log directory per (cell, "
                         "sync/async) run under this directory, merged "
                         "to telemetry.jsonl at the end")
    ap.add_argument("--profile-dir", default=None,
                    help="a torch.profiler trace of the sweep in this "
                         "process into DIR/trace.json (the spawned ranks "
                         "do not profile)")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    from repro_torch.launch import variants
    scenarios = [s.strip() for s in args.scenarios.split(",") if s.strip()]
    unknown = set(scenarios) - set(variants.MARL_SCENARIOS) - set(SCENARIOS)
    if unknown:
        ap.error(f"unknown scenarios {sorted(unknown)}")
    for flag in ("rounds", "inner"):
        if getattr(args, flag) is not None and getattr(args, flag) < 1:
            ap.error(f"--{flag} must be >= 1")
    shard_counts = sorted({int(s) for s in args.shards.split(",")
                           if s.strip()})
    if shard_counts and shard_counts[0] < 1:
        ap.error("--shards must be >= 1")
    processes = (sorted({int(p) for p in args.processes.split(",")})
                 if args.processes else None)
    cells, streams_list = plan(
        scenarios, shard_counts, processes,
        sorted({int(s) for s in args.streams.split(",")})
        if args.streams else [], args.side)
    if not streams_list and not any(cells.values()):
        ap.error(f"--processes {args.processes} --shards {args.shards!r} "
                 f"--streams {args.streams}: no row left; {PROCESS_RULE}")

    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
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

    pairs = []
    with obs_trace.profile(args.profile_dir):
        for scenario, counts in cells.items():
            pairs += sharded_rows(scenario, counts, args, device, sync)
        for streams in streams_list:
            pairs.append(run_cell(
                scenarios[0], args, device, sync, streams=streams,
                label=f"{scenarios[0]}-streams{streams}"))
    rows = [row for row, _ in pairs]
    spreads = {row["label"]: sp for row, sp in pairs}
    problems = [p for r in rows for p in obs_metrics.validate_bench_row(
        r, obs_metrics.SCALING_ROW_SCHEMA)]
    if problems:
        for p in problems:
            print(f"SCHEMA-INVALID {p}", file=sys.stderr)
        return 1
    record = {"device": {"platform": platform, "kind": kind,
                         "count": count},
              "card": card,
              "config": {"fast": args.fast, "side": args.side,
                         "rounds": args.rounds, "inner": args.inner,
                         "seed": args.seed, "shards": shard_counts,
                         "processes": processes, "streams": streams_list,
                         "max_aip_staleness": 2},
              "rows": rows, "spread": spreads}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
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
    if args.telemetry_dir:
        print(f"# merged telemetry in {merge_telemetry(args.telemetry_dir)} "
              f"cell dir(s) under {args.telemetry_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
