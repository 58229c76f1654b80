"""Paper Figure 3 in miniature with the PyTorch/CUDA port: train a
4-agent networked system with (a) the global simulator, (b) DIALS, (c)
untrained-DIALS, and compare final returns and wall time — the
counterpart of ``examples/traffic_gs_vs_dials.py``. Defaults to the 2x2
traffic grid; any env of the port's registry works.

Run:  PYTHONPATH=src python examples/torch_traffic_gs_vs_dials.py \\
          [--rounds N] [--inner F] [--env traffic] [--device cuda|cpu] \\
          [--shards N] [--async-collect] [--telemetry-dir DIR]

``--device`` defaults to ``cuda`` and raises without a card.
``--shards N`` runs the DIALS trainings on the agent-sharded round, one
shard per process: the example starts N local ranks of one gloo group
through the ``DIALS_*`` contract (``repro_torch.distributed.bootstrap``;
on a card they share it), unless it was itself started as one rank of a
group (``DIALS_COORDINATOR``/``DIALS_NUM_PROCESSES``/``DIALS_PROCESS_ID``
set), when it joins that group. The GS baseline runs in one process.
``--async-collect`` overlaps each round's GS collect with the previous
round's inner steps (one-round dataset lag, bounded by
``max_aip_staleness``; on the card the collect runs on a CUDA stream of
its own). ``--telemetry-dir`` writes each DIALS run's JSONL event log
into a subdirectory of DIR (check it with ``python -m
tools.telemetry_report DIR/DIALS --check``).
"""
import argparse
import os
import time

import torch

from repro_torch import random as R
from repro_torch.core import dials, influence
from repro_torch.distributed import bootstrap
from repro_torch.envs import registry
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.marl import policy, ppo, runner


def setup(args):
    env_mod, env_cfg = registry.make(args["env"], side=2, horizon=32)
    info = env_cfg.info()
    pc = policy.PolicyConfig(obs_dim=info.obs_dim,
                             n_actions=info.n_actions, hidden=(64, 64))
    ac = influence.AIPConfig(in_dim=info.alsh_dim,
                             n_sources=info.n_influence, kind="fnn",
                             hidden=(32, 32), epochs=10, batch=64, lr=1e-3)
    return env_mod, env_cfg, pc, ac, ppo.PPOConfig()


def run_dials(args):
    """DIALS and untrained-DIALS: {name: (final GS return, wall s)}. One
    rank of the sharded run when ``--shards`` > 1 (every rank returns the
    same records)."""
    ctx = bootstrap.bootstrap()
    device = resolve_device(args["device"])
    if ctx.distributed and device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // ctx.num_processes))
    env_mod, env_cfg, pc, ac, ppo_cfg = setup(args)
    results = {}
    for untrained in (False, True):
        name = "untrained-DIALS" if untrained else "DIALS"
        cfg = dials.DIALSConfig(
            outer_rounds=args["rounds"], aip_refresh=args["inner"],
            collect_envs=8, collect_steps=64, n_envs=8, rollout_steps=16,
            untrained=untrained, eval_episodes=8, shards=args["shards"],
            async_collect=args["async_collect"],
            telemetry_dir=(os.path.join(args["telemetry_dir"], name)
                           if args["telemetry_dir"] else None))
        t0 = time.time()
        _, hist = dials.DIALSTrainer(
            env_mod, env_cfg, pc, ac, ppo_cfg, cfg, device=device).run(
            R.key(0))
        results[name] = (hist[-1]["gs_return"], time.time() - t0)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--env", default="traffic", choices=registry.names())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="agent-sharded round, one shard per local rank")
    ap.add_argument("--async-collect", action="store_true",
                    help="double-buffered overlapped GS collect")
    ap.add_argument("--telemetry-dir", default=None,
                    help="per-run JSONL telemetry under this directory")
    args = vars(ap.parse_args())
    device = resolve_device(args["device"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if (args["shards"] or 1) > 1 and bootstrap.config_from_env() is None:
        print(f"starting {args['shards']} local ranks", flush=True)
        results = bootstrap.spawn_local(args["shards"], run_dials, args)[0]
    else:
        results = run_dials(args)
        if bootstrap.config_from_env() is not None:
            bootstrap.shutdown()
            if int(os.environ[bootstrap.ENV_PROCESS_ID]):
                return                   # rank 0 reports
    env_mod, env_cfg, pc, _, ppo_cfg = setup(args)

    # GS baseline: the same number of PPO iterations, on the global sim
    init_fn, train_fn, eval_fn = runner.make_gs_trainer(
        env_mod, env_cfg, pc, ppo_cfg,
        runner.RunConfig(n_envs=8, rollout_steps=16), device=device)
    state = init_fn(R.key(0))
    t0 = time.time()
    for _ in range(args["rounds"] * args["inner"]):
        state, _ = train_fn(state)
    ret = float(eval_fn(state["params"], R.key(1), episodes=8))
    sync()
    results["GS"] = (ret, time.time() - t0)

    print(f"\n{'simulator':<18}{'final GS return':>16}{'wall s':>10}")
    for name, (r, w) in results.items():
        print(f"{name:<18}{r:>16.4f}{w:>10.1f}")
    print("\nThe paper's claims in miniature: DIALS ≈ or > GS return; "
          "untrained-DIALS trails (learned influence matters).")


if __name__ == "__main__":
    main()
