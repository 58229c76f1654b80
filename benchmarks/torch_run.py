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

The reference's ``roofline`` table reads the LM dry-run records and
waits for the LM mesh (ROADMAP queue 1 item 12d); it is not registered.

The port runs one shard per process, so ``--shards N`` with N > 1 and
``--sharded-gs on`` are refused: the sharded rows come from
``benchmarks/torch_scaling.py --shards``, which starts the ranks.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_run.py [--only NAME] [--fast]
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
SHARDS_REFUSAL = (
    "the port runs one shard per process: run the sharded rows with "
    "benchmarks/torch_scaling.py --shards, which starts one rank per shard")


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


def refuse_sharded(shards, sharded_gs) -> None:
    """Raise for the reference's in-process sharded options."""
    if shards is not None and shards > 1:
        raise ValueError(f"--shards {shards}: {SHARDS_REFUSAL}")
    if sharded_gs == "on":
        raise ValueError(f"--sharded-gs on: {SHARDS_REFUSAL}")


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


def fig3_env_rows(env_name, *, rounds, inner, device="cuda",
                  use_kernels="auto", shards=None, async_collect=False,
                  sharded_gs="auto", collect_streams=None, state=None,
                  gs_state=None):
    """One env of :func:`fig3_learning`: its DIALS, untrained-DIALS and GS
    rows, in that order. ``state`` (a ``DIALSTrainer`` state) and
    ``gs_state`` (a ``make_gs_trainer`` state) replace the trainers'
    own inits, e.g. the reference's through ``repro_torch.convert``."""
    from repro_torch import random as R
    from repro_torch.core import dials
    from repro_torch.marl import runner
    refuse_sharded(shards, sharded_gs)
    env_mod, env_cfg, info, pc, ac, ppo_cfg = _setup(env_name, 2)
    rows = []
    # --- DIALS and untrained-DIALS
    for untrained in (False, True):
        cfg = _dials_config(rounds=rounds, inner=inner, untrained=untrained,
                            use_kernels=use_kernels, shards=shards,
                            async_collect=async_collect,
                            sharded_gs=sharded_gs,
                            collect_streams=collect_streams)
        tr = dials.DIALSTrainer(env_mod, env_cfg, pc, ac, ppo_cfg, cfg,
                                device=device)
        t0 = time.perf_counter()
        _, hist = tr.run(R.key(0, device=device),
                         state=None if state is None else _clone(state))
        label = ("untrained-DIALS" if untrained else "DIALS") \
            + f"-{env_name}"
        rows.append({"label": label,
                     "final_gs_return": hist[-1]["gs_return"],
                     "best_gs_return": max(h["gs_return"] for h in hist),
                     "aip_ce_final": hist[-1]["aip_ce_after"],
                     "wall_s": time.perf_counter() - t0})
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
    """AIP training frequency F: returns + influence CE (paper Fig. 4)."""
    from repro_torch import random as R
    from repro_torch.core import dials
    refuse_sharded(shards, sharded_gs)
    rows = []
    total_inner = 12 if fast else 60
    sweeps = ((2, 6), (6, 2), (total_inner, 1)) if fast else \
        ((5, 12), (15, 4), (30, 2), (60, 1))
    env_mod, env_cfg, info, pc, ac, ppo_cfg = _setup("warehouse", 2)
    for refresh, rounds in sweeps:
        cfg = _dials_config(rounds=rounds, inner=refresh,
                            use_kernels=use_kernels, shards=shards,
                            async_collect=async_collect,
                            sharded_gs=sharded_gs)
        tr = dials.DIALSTrainer(env_mod, env_cfg, pc, ac, ppo_cfg, cfg,
                                device=device)
        t0 = time.perf_counter()
        _, hist = tr.run(R.key(0, device=device))
        rows.append({"label": f"F={refresh}x{rounds}",
                     "refresh": refresh,
                     "final_gs_return": hist[-1]["gs_return"],
                     "aip_ce_final": hist[-1]["aip_ce_after"],
                     "wall_s": time.perf_counter() - t0})
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


BENCHES = {
    "fig3_learning": fig3_learning,
    "fig3_scalability": fig3_scalability,
    "fig4_f_sweep": fig4_f_sweep,
    "table_lemma2": table_lemma2,
    "table_memory": table_memory,
}
NOT_PORTED = {"roofline": "it reads the LM dry-run records of the LM "
                          "mesh, ROADMAP queue 1 item 12d"}


def main(argv=None) -> int:
    import inspect
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="reduced iteration counts (CI mode)")
    ap.add_argument("--shards", type=int, default=None,
                    help="1 = the loop path (the default in one process); "
                         "more is refused: use benchmarks/torch_scaling.py "
                         "--shards")
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
                    help="'on' is refused (one shard per process)")
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
    if args.only in NOT_PORTED:
        ap.error(f"{args.only} is not ported: {NOT_PORTED[args.only]}")
    if args.only is not None and args.only not in BENCHES:
        ap.error(f"unknown bench {args.only!r}, of {sorted(BENCHES)}")
    try:
        refuse_sharded(args.shards, args.sharded_gs)
    except ValueError as e:
        ap.error(str(e))

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
