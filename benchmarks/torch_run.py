"""The paper's experiment harness on the PyTorch/CUDA port — the port of
``benchmarks/run.py``: one function per paper table or figure, with the
reference's sizes, widths, labels and row keys.

  fig3_learning      GS vs DIALS vs untrained-DIALS on the 4-agent envs
                     (paper Fig. 3 1a/1b); :func:`fig3_env_rows` is one
                     env's three rows.
  fig3_scalability   GS and IALS iteration seconds vs system size
                     (paper Fig. 3 3a/3b + Tables 1-2).
  fig4_f_sweep       AIP refresh frequency F sweep + influence CE
                     (paper Fig. 4).
  table_lemma2       Lemma-2 bound certificate sweep (paper Sec. 4.1.2),
                     float64 on the CPU whatever ``--device`` says.
  table_memory       GS vs per-agent LS state bytes (paper Table 3).

  roofline           the three roofline terms of every dry-run record
                     on disk (``experiments/dryrun_torch``, written by
                     ``python -m repro_torch.launch.dryrun``), with the
                     H100's constants (``benchmarks/torch_roofline.py``).

``--shards N`` (N > 1) runs the DIALS cells of ``fig3_learning`` (each
env's, through :func:`fig3_env_rows`) and ``fig4_f_sweep`` on the
agent-sharded round, one shard per process: N local ranks of one gloo
group, started by ``repro_torch.distributed.bootstrap.spawn_local`` (on
a card they share it), rank 0's records kept; the GS baseline runs in
the parent, as the reference's does. ``--sharded-gs on|off`` forces the
region-decomposed GS collect on or off there; ``on`` without N > 1
raises, as ``DIALSTrainer.run`` does.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_run.py [--only NAME] [--fast]
        [--shards N] [--sharded-gs auto|on|off]
        [--use-kernels auto|on|off] [--async-collect]
        [--collect-streams S] [--profile-dir DIR]

``--device cpu`` is a rehearsal on the host (plain versions; its times
are the CPU's). Output: ``name.label,metric,value`` lines, the
reference's names and labels line for line, and each table's rows in
``experiments/bench/torch_<name>.json`` (beside the reference's
``<name>.json``), both relative to the working directory.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT_DIR = os.path.join("experiments", "bench")
# the spawned ranks of a --shards N run: a bench's whole sweep, so the
# limit is the longest run's (the full fig4 sweep), not a test's
SHARDED_TIMEOUT_S = 12 * 3600.0


def _emit(rows, name):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"torch_{name}.json"), "w") as f:
        json.dump(rows, f, indent=1, default=float)
    for r in rows:
        for k, v in r.items():
            if k in ("name", "label"):
                continue
            print(f"{name}.{r.get('label', '')},{k},{v}", flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


# ---------------------------------------------------------------------------
# the shared small-scale MARL setup (the reference's CPU-budget versions of
# the paper envs), resolved through repro_torch.envs.registry
# ---------------------------------------------------------------------------
def _env_names():
    from repro_torch.envs import registry
    return registry.names()


def _setup(env_name, n_side, *, horizon=32):
    from repro_torch.core import influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy, ppo
    env_mod, env_cfg = registry.make(env_name, side=n_side, horizon=horizon)
    info = env_cfg.info()
    pc = policy.PolicyConfig(obs_dim=info.obs_dim, n_actions=info.n_actions,
                             hidden=(64, 64))
    ac = influence.AIPConfig(in_dim=info.alsh_dim,
                             n_sources=info.n_influence,
                             kind="fnn", hidden=(32, 32), epochs=10,
                             batch=64, lr=1e-3)
    ppo_cfg = ppo.PPOConfig()
    return env_mod, env_cfg, info, pc, ac, ppo_cfg


def _dials_config(*, rounds, inner, untrained=False, use_kernels="auto",
                  shards=None, async_collect=False, sharded_gs="auto",
                  collect_streams=None):
    """The reference's DIALS cell (``run.py:84-91``)."""
    from repro_torch.core import dials
    from repro_torch.launch import variants
    return dials.DIALSConfig(
        outer_rounds=rounds, aip_refresh=inner, collect_envs=8,
        collect_steps=64, n_envs=8, rollout_steps=16, untrained=untrained,
        eval_episodes=8, use_kernels=use_kernels,
        **variants.dials_variant_for(shards, async_collect, sharded_gs,
                                     streams=collect_streams))


def _dials_runs(env_name, cells, device, state=None):
    """``DIALSTrainer.run`` from key 0 for each cell (``_dials_config``
    keywords) on ``env_name`` at side 2, from ``state`` when given:
    [(history, wall seconds)]."""
    from repro_torch import random as R
    from repro_torch.core import dials
    from repro_torch.tree import tree_map
    env_mod, env_cfg, _info, pc, ac, ppo_cfg = _setup(env_name, 2)
    out = []
    for cell in cells:
        tr = dials.DIALSTrainer(env_mod, env_cfg, pc, ac, ppo_cfg,
                                _dials_config(**cell), device=device)
        start = None if state is None else tree_map(
            lambda x: x.to(device, copy=True)
            if isinstance(x, torch.Tensor) else x, state)
        t0 = time.perf_counter()
        _, hist = tr.run(R.key(0, device=device), state=start)
        _sync(device)
        out.append((hist, time.perf_counter() - t0))
    return out


def _dials_rank(env_name, cells, device, state):
    """One rank of a ``--shards N`` run: joins the group the ``DIALS_*``
    contract declares and runs its shard of every cell."""
    from repro_torch.distributed import bootstrap
    from repro_torch.kernels import dispatch
    ctx = bootstrap.bootstrap()
    device = dispatch.resolve_device(device)
    if device.type == "cpu":       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // ctx.num_processes))
    return _dials_runs(env_name, cells, device, state)


def dials_runs(env_name, cells, *, device, shards=None, state=None):
    """:func:`_dials_runs` in this process, or, with ``shards`` > 1 and no
    group declared around this process, on ``shards`` ranks spawned by
    ``bootstrap.spawn_local`` (each runs its shard of the sharded round;
    rank 0's records are returned)."""
    from repro_torch.distributed import bootstrap
    from repro_torch.tree import tree_map
    if (shards or 1) > 1 and bootstrap.config_from_env() is None:
        host = None if state is None else tree_map(
            lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)
        return bootstrap.spawn_local(shards, _dials_rank, env_name, cells,
                                     str(device), host,
                                     timeout_s=SHARDED_TIMEOUT_S)[0]
    return _dials_runs(env_name, cells, device, state)


def fig3_env_rows(env_name, *, rounds, inner, device="cuda",
                  use_kernels="auto", shards=None, async_collect=False,
                  sharded_gs="auto", collect_streams=None, state=None,
                  gs_state=None):
    """One env of :func:`fig3_learning`: its DIALS, untrained-DIALS and GS
    rows, in that order. ``state`` (a ``DIALSTrainer`` state) and
    ``gs_state`` (a ``make_gs_trainer`` state) replace the trainers'
    own inits, e.g. the reference's through ``repro_torch.convert``.
    ``shards`` > 1 runs the two DIALS cells on spawned ranks
    (:func:`dials_runs`)."""
    from repro_torch import random as R
    from repro_torch.marl import runner
    env_mod, env_cfg, info, pc, ac, ppo_cfg = _setup(env_name, 2)
    rows = []
    # --- DIALS and untrained-DIALS
    cells = [dict(rounds=rounds, inner=inner, untrained=untrained,
                  use_kernels=use_kernels, shards=shards,
                  async_collect=async_collect, sharded_gs=sharded_gs,
                  collect_streams=collect_streams)
             for untrained in (False, True)]
    runs = dials_runs(env_name, cells, device=device, shards=shards,
                      state=state)
    for cell, (hist, wall) in zip(cells, runs):
        label = ("untrained-DIALS" if cell["untrained"] else "DIALS") \
            + f"-{env_name}"
        rows.append({"label": label,
                     "final_gs_return": hist[-1]["gs_return"],
                     "best_gs_return": max(h["gs_return"] for h in hist),
                     "aip_ce_final": hist[-1]["aip_ce_after"],
                     "wall_s": wall})
    # --- GS baseline: the same number of env steps
    init_fn, train_fn, eval_fn = runner.make_gs_trainer(
        env_mod, env_cfg, pc, ppo_cfg,
        runner.RunConfig(n_envs=8, rollout_steps=16), device=device)
    gs = (init_fn(R.key(0, device=device)) if gs_state is None
          else _clone(gs_state))
    t0 = time.perf_counter()
    for _ in range(rounds * inner):
        gs, _m = train_fn(gs)
    ret = float(eval_fn(gs["params"], R.key(1, device=device), episodes=8))
    rows.append({"label": f"GS-{env_name}", "final_gs_return": ret,
                 "wall_s": time.perf_counter() - t0})
    return rows


def fig3_learning(fast: bool = False, shards=None, async_collect=False,
                  use_kernels="auto", sharded_gs="auto",
                  collect_streams=None, device="cuda"):
    """GS vs DIALS vs untrained-DIALS mean return (4-agent envs)."""
    rounds = 3 if fast else 10
    inner = 10 if fast else 40
    rows = []
    for env_name in _env_names():
        rows += fig3_env_rows(env_name, rounds=rounds, inner=inner,
                              device=device, use_kernels=use_kernels,
                              shards=shards, async_collect=async_collect,
                              sharded_gs=sharded_gs,
                              collect_streams=collect_streams)
    _emit(rows, "fig3_learning")
    return rows


def fig3_scalability(fast: bool = False, device="cuda"):
    """Per-iteration seconds vs number of agents. The paper's claim: GS
    cost grows with system size; DIALS per-agent work is ~flat (the
    agent axis is batched, and between AIP refreshes there is no
    cross-agent work). Each program runs once untimed, then 3 timed
    iterations end in a synchronise."""
    from repro_torch import random as R
    from repro_torch.core import ials as ials_mod, influence
    from repro_torch.marl import runner
    rows = []
    sides = (2, 3) if fast else (2, 3, 4, 5)
    for env_name in _env_names():
        for side in sides:
            env_mod, env_cfg, info, pc, ac, ppo_cfg = _setup(env_name, side)
            n = info.n_agents
            # GS trainer iteration
            init_fn, train_fn, _ = runner.make_gs_trainer(
                env_mod, env_cfg, pc, ppo_cfg,
                runner.RunConfig(n_envs=4, rollout_steps=16), device=device)
            state = init_fn(R.key(0, device=device))
            state, _ = train_fn(state)                  # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = train_fn(state)
            _sync(device)
            gs_it = (time.perf_counter() - t0) / 3
            # IALS trainer iteration (the DIALS inner loop)
            iinit, itrain = ials_mod.make_ials_trainer(
                env_mod, env_cfg, pc, ac, ppo_cfg, n_envs=4,
                rollout_steps=16, device=device)
            istate = iinit(R.key(0, device=device))
            aips = influence.aip_init(R.split(R.key(1, device=device), n),
                                      ac)
            istate, _ = itrain(istate, aips)            # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                istate, _ = itrain(istate, aips)
            _sync(device)
            ials_it = (time.perf_counter() - t0) / 3
            rows.append({"label": f"{env_name}-{n}agents",
                         "n_agents": n,
                         "gs_iter_s": gs_it,
                         "dials_iter_s": ials_it,
                         # per-agent: the distributed-deployment number —
                         # one process per agent runs 1/n of this program
                         "dials_iter_per_agent_s": ials_it / n,
                         "speedup_at_scale": gs_it / (ials_it / n)})
    _emit(rows, "fig3_scalability")
    return rows


def fig4_f_sweep(fast: bool = False, shards=None, async_collect=False,
                 use_kernels="auto", sharded_gs="auto", device="cuda"):
    """AIP training frequency F: returns + influence CE (paper Fig. 4).
    ``shards`` > 1 runs the sweep's cells on spawned ranks
    (:func:`dials_runs`)."""
    total_inner = 12 if fast else 60
    sweeps = ((2, 6), (6, 2), (total_inner, 1)) if fast else \
        ((5, 12), (15, 4), (30, 2), (60, 1))
    cells = [dict(rounds=rounds, inner=refresh, use_kernels=use_kernels,
                  shards=shards, async_collect=async_collect,
                  sharded_gs=sharded_gs)
             for refresh, rounds in sweeps]
    runs = dials_runs("warehouse", cells, device=device, shards=shards)
    rows = [{"label": f"F={cell['inner']}x{cell['rounds']}",
             "refresh": cell["inner"],
             "final_gs_return": hist[-1]["gs_return"],
             "aip_ce_final": hist[-1]["aip_ce_after"],
             "wall_s": wall}
            for cell, (hist, wall) in zip(cells, runs)]
    _emit(rows, "fig4_f_sweep")
    return rows


def table_lemma2(fast: bool = False):
    """Empirical Lemma-2 certificates: ξ vs |Q1-Q2| vs bound (float64,
    CPU)."""
    from repro_torch.core import ialm, theory
    rows = []
    rng = np.random.default_rng(0)
    T1, T2, R, pi2, b0 = ialm.random_system(rng)
    base = ialm.exact_influence(T1, T2, pi2, b0)
    nu, na = T1.shape[1], T1.shape[2]
    for eps in (0.0, 0.05, 0.1, 0.2, 0.4):
        pert = theory.perturbed_influence(base, eps, nu)
        cert = theory.lemma2_certificate(
            T1, R, horizon=4, influence1=base, influence2=pert,
            policy=lambda l: torch.full((na,), 1 / na, dtype=ialm.DTYPE))
        rows.append({"label": f"eps={eps}", "xi": cert["xi"],
                     "lhs_maxQdiff": cert["lhs"], "bound": cert["bound"],
                     "holds": int(cert["holds"])})
    _emit(rows, "table_lemma2")
    return rows


def state_bytes(tree, device) -> tuple:
    """``(reference, port)`` bytes of an env state whose every leaf lies
    on a device of ``device``'s type (raises otherwise). ``reference``
    counts each integer leaf at the reference's int32/uint32 width, bools
    and floats at their own: the simulator state the reference holds.
    ``port`` counts each leaf at the width the port holds it, integers
    as int64: twice the reference's bytes for those leaves."""
    from repro_torch.tree import leaves
    ref = port = 0
    for x in leaves(tree):
        if x.device.type != device.type:
            raise RuntimeError(f"a state leaf lies on {x.device}, "
                               f"not {device}")
        width = (4 if not x.dtype.is_floating_point and x.dtype != torch.bool
                 else x.element_size())
        ref += x.numel() * width
        port += x.numel() * x.element_size()
    return ref, port


def table_memory(fast: bool = False, device="cuda"):
    """Paper Table 3 analogue: state bytes of GS vs per-agent LS, the
    states initialised on ``device``. The reference's columns count the
    reference's dtypes; the ``*_port`` columns count what the port holds
    on ``device``."""
    from repro_torch import random as R
    from repro_torch.envs import registry
    from repro_torch.kernels import dispatch
    device = dispatch.resolve_device(device)
    rows = []
    for side in (2, 5, 7, 10):
        for env_name in _env_names():
            mod, cfg = registry.make(env_name, side=side)
            gs, gs_port = state_bytes(
                mod.gs_init(R.key(0, device=device), cfg), device)
            ls, ls_port = state_bytes(
                mod.ls_init(R.key(0, device=device), cfg), device)
            n = cfg.n_agents
            rows.append({"label": f"{env_name}-{n}agents",
                         "n_agents": n,
                         "gs_state_bytes": gs,
                         "ls_state_bytes_per_agent": ls,
                         "ls_total_bytes": ls * n,
                         "gs_state_bytes_port": gs_port,
                         "ls_state_bytes_per_agent_port": ls_port,
                         "ls_total_bytes_port": ls_port * n})
    _emit(rows, "table_memory")
    return rows


def roofline_table(fast: bool = False):
    """§Roofline: three terms per dry-run cell on disk
    (experiments/dryrun_torch), the H100's constants."""
    import glob
    from benchmarks import torch_roofline
    rows = []
    for fn in sorted(glob.glob("experiments/dryrun_torch/*.json")):
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        t = torch_roofline.terms(**torch_roofline.per_device(rec))
        rows.append({"label": os.path.basename(fn)[:-5],
                     "arch": rec["arch"], "shape": rec["shape"],
                     "mesh": rec["mesh"], "variant": rec.get("variant"),
                     **{k: v for k, v in t.items()}})
    _emit(rows, "roofline")
    return rows


BENCHES = {
    "fig3_learning": fig3_learning,
    "fig3_scalability": fig3_scalability,
    "fig4_f_sweep": fig4_f_sweep,
    "table_lemma2": table_lemma2,
    "table_memory": table_memory,
    "roofline": roofline_table,
}


def main(argv=None) -> int:
    import inspect
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="reduced iteration counts (CI mode)")
    ap.add_argument("--shards", type=int, default=None,
                    help="DIALS runtime shard count: N > 1 runs the DIALS "
                         "cells on N spawned local ranks, one shard each "
                         "(None = auto, 1 = the loop path)")
    ap.add_argument("--async-collect", action="store_true",
                    help="overlap each round's GS collect with the "
                         "previous round's inner steps (one-round "
                         "dataset lag, bounded by max_aip_staleness)")
    ap.add_argument("--use-kernels", default="auto",
                    choices=("auto", "on", "off"),
                    help="the CUDA kernels for the AIP/policy GRU and GAE "
                         "(auto = kernel on the card, plain version on "
                         "the CPU; on = kernel, raises on the CPU)")
    ap.add_argument("--sharded-gs", default="auto",
                    choices=("auto", "on", "off"),
                    help="region-decomposed GS collect/eval on the shards "
                         "(auto = whenever the env partition supports the "
                         "shard count; on needs --shards N > 1)")
    ap.add_argument("--collect-streams", type=int, default=None,
                    help="GS env-stream count S for the DIALS cells "
                         "(None = collect_envs)")
    ap.add_argument("--profile-dir", default=None,
                    help="a torch.profiler trace of the whole sweep into "
                         "this directory (trace.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or "
                         "cpu, a rehearsal on the host")
    args = ap.parse_args(argv)
    if args.only is not None and args.only not in BENCHES:
        ap.error(f"unknown bench {args.only!r}, of {sorted(BENCHES)}")

    from repro_torch.kernels import dispatch
    from repro_torch.obs import trace as obs_trace
    device = dispatch.resolve_device(args.device)   # raises without a card
    if device.type == "cuda":
        import chip_smoke
        print(f"# card: {chip_smoke.smi_line()}", flush=True)
    names = [args.only] if args.only else list(BENCHES)
    print("name,metric,value", flush=True)
    with obs_trace.profile(args.profile_dir):
        for n in names:
            fn = BENCHES[n]
            params = inspect.signature(fn).parameters
            kw = {"fast": args.fast}
            for k in ("shards", "async_collect", "use_kernels",
                      "sharded_gs", "collect_streams"):
                if k in params:
                    kw[k] = getattr(args, k)
            if "device" in params:
                kw["device"] = device
            t0 = time.perf_counter()
            fn(**kw)
            print(f"# {n}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.profile_dir:
        print(f"# profiler trace written to {args.profile_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
