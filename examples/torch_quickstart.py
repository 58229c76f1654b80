"""Quickstart with the PyTorch/CUDA port: train a 4-agent networked
system with DIALS — the counterpart of ``examples/quickstart.py``.

The three moving parts of the paper, end to end:
  1. a GLOBAL simulator (GS) used only to collect (ALSH, u) datasets,
  2. per-agent APPROXIMATE INFLUENCE PREDICTORS (AIPs) trained on them,
  3. per-agent LOCAL simulators (IALS) driven by the frozen AIPs, on which
     every agent trains PPO for F steps between AIP refreshes.

Any environment of the port's registry works (traffic, warehouse,
powergrid, supplychain).

Run:  PYTHONPATH=src python examples/torch_quickstart.py \\
          [--env warehouse] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse

from repro_torch import random as R
from repro_torch.core import dials, influence
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="warehouse", choices=registry.names())
    ap.add_argument("--side", type=int, default=2,
                    help="uniform size knob (side=2 -> 4 agents)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    env_mod, env_cfg = registry.make(args.env, side=args.side, horizon=32)
    info = env_cfg.info()

    policy_cfg = policy.PolicyConfig(
        obs_dim=info.obs_dim, n_actions=info.n_actions, hidden=(64, 64))
    aip_cfg = influence.AIPConfig(
        in_dim=info.alsh_dim, n_sources=info.n_influence,
        kind="fnn", hidden=(32, 32), epochs=10, batch=64, lr=1e-3)

    cfg = dials.DIALSConfig(
        outer_rounds=4,        # collect -> AIP train -> F inner steps, x4
        aip_refresh=20,        # F: PPO iterations between AIP refreshes
        collect_envs=8, collect_steps=64,
        n_envs=8, rollout_steps=16, eval_episodes=8)

    trainer = dials.DIALSTrainer(
        env_mod, env_cfg, policy_cfg, aip_cfg, ppo.PPOConfig(), cfg,
        device=args.device)

    print(f"training {info.n_agents} {args.env} agents with DIALS on "
          f"{trainer.device} (F={cfg.aip_refresh} PPO iters/refresh)")
    _, history = trainer.run(R.key(0), log=lambda r: print(
        f"  round {r['round']}: GS return {r['gs_return']:.4f}  "
        f"AIP CE {r['aip_ce_before']:.3f}->{r['aip_ce_after']:.3f}  "
        f"({r['wall_s']:.0f}s)"))

    first, last = history[0], history[-1]
    print(f"\nGS return {first['gs_return']:.4f} -> {last['gs_return']:.4f}")
    print("done.")


if __name__ == "__main__":
    main()
