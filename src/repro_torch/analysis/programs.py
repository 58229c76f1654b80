"""Program registry for the contract checker — the port of
``repro/analysis/programs.py``.

This module builds every program the port's contracts hold as a
:class:`repro_torch.analysis.contracts.Program`: a callable and real
inputs at tiny sizes (the reference traces abstractly; an eager program
is only known by running it, so the inputs are real, and small):

* the **loop driver**'s pieces under the reference's names and roles
  (collect, the ring collect, AIP training, the fused AIP round, the
  IALS inner step, the GS eval), each with the ``feedback`` that makes
  its next call's inputs from its outputs (the state a replayed CUDA
  graph carries forward);
* one **round** of the driver, for the round record's schema;
* the **kernel dispatch paths** (the GRU and GAE ops, plain and, on a
  card, kernel) as dtype round-trip programs;
* the **wide-stream** ring collect at S=64 streams;
* the **sharded round**'s per-shard train body and region-decomposed GS
  bodies (:func:`sharded_programs`), on this process's shard mesh: one
  shard without a process group, one per rank inside one.

The post-loss resume path (``recovery_programs``) comes with the
sharded runtime's fault-tolerance half (ROADMAP queue 1 item 9). New
programs register here: extend :func:`loop_programs` or append a builder
via :func:`register_programs`; ``tools/check_programs_torch.py`` checks
whatever this module yields. Every builder runs on CUDA unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Optional

import torch

from repro_torch.analysis.contracts import Program
from repro_torch.tree import leaves

__all__ = ["tiny_trainer", "loop_programs", "round_programs",
           "kernel_dtype_programs", "stream_programs", "sharded_programs",
           "all_programs", "register_programs", "KINDS"]

KINDS = ("fnn", "gru")

# extension point: fns (device) -> List[Program], run by all_programs()
_EXTRA_BUILDERS: List[Callable[..., List[Program]]] = []


def register_programs(builder: Callable[..., List[Program]]) -> None:
    """Register more programs with the checker: ``builder(device)``
    returns a list of :class:`Program`."""
    _EXTRA_BUILDERS.append(builder)


def tiny_trainer(env: str, *, kind: str = "fnn", device="cuda", **kw):
    """A ``DIALSTrainer`` at the reference's tiny sizes
    (``repro/analysis/programs.py``'s ``tiny_trainer``)."""
    from repro_torch.core import dials, influence
    from repro_torch.envs import registry
    from repro_torch.marl import policy as policy_mod, ppo as ppo_mod

    env_mod, cfg = registry.make(env, horizon=16)
    info = cfg.info()
    pc = policy_mod.PolicyConfig(obs_dim=info.obs_dim,
                                 n_actions=info.n_actions, kind=kind,
                                 hidden=(16,), gru_hidden=8)
    ac = influence.AIPConfig(in_dim=info.alsh_dim,
                             n_sources=info.n_influence, kind=kind,
                             hidden=(16,), gru_hidden=8, epochs=2,
                             batch=16)
    ppo_cfg = ppo_mod.PPOConfig(epochs=1, minibatches=2)
    dcfg = dials.DIALSConfig(**{
        **dict(outer_rounds=2, aip_refresh=2, collect_envs=2,
               collect_steps=16, n_envs=2, rollout_steps=8,
               eval_episodes=2), **kw})
    return dials.DIALSTrainer(env_mod, cfg, pc, ac, ppo_cfg, dcfg,
                              device=device)


def _feed_first(args, out):
    """The next call of a functional program takes its output's first
    element in place of its first input."""
    return (out[0],) + tuple(args[1:])


def _feed_aip_round(args, out):
    """``aip_round``'s next call: its new AIPs and reports."""
    return (out[0],) + tuple(args[1:4]) + (out[1],) + tuple(args[5:])


def _slot_leaves(slot):
    return [(tuple(x.shape), x.dtype) for x in leaves(slot)]


def _ring_program(name, trainer, params, key) -> Program:
    """The in-place ring-slot collect into a fresh zero slot: the
    RingBufferResident pair of claims (no host round trip, no
    reallocation) the DeviceRing makes."""
    from repro_torch.core import dials, gs as gs_mod
    slot = gs_mod.zero_dataset(
        trainer.env_cfg, n_envs=dials.collect_stream_count(trainer.cfg),
        steps=trainer.cfg.collect_steps, device=trainer.device)
    return Program(name=name, roles=("ring_collect", "donated", "program"),
                   fn=trainer.collect_into, args=(slot, params, key),
                   meta={"expect": _slot_leaves(slot)})


def loop_programs(env: str, *, kind: str = "fnn", device="cuda",
                  trainer=None, seed: int = 0) -> List[Program]:
    """The loop driver's pieces with real inputs: ``trainer`` (default
    :func:`tiny_trainer`), its state from ``seed``, one collected
    dataset."""
    from repro_torch import random as R
    from repro_torch.core import gs as gs_mod
    from repro_torch.core import influence

    if trainer is None:
        trainer = tiny_trainer(env, kind=kind, device=device, shards=1)
    info, cfg, dev = trainer.info, trainer.cfg, trainer.device
    key = R.key(seed, device=dev)
    state = trainer.init(key)
    params, aips = state["ials"]["params"], state["aips"]
    data = trainer.collect(params, key)
    train_data = gs_mod.split_dataset(data, trainer.n_eval_seqs)[0]
    agent_keys = R.split(key, info.n_agents)
    mask = torch.ones((info.n_agents,), device=dev)
    reports = torch.zeros((info.n_agents,), dtype=torch.int64, device=dev)
    aip_cfg = trainer.aip_cfg

    def train_aips(aips, data, keys):
        return influence.train_aip(aips, data, keys, aip_cfg)

    pre = f"loop/{env}"
    return [
        Program(name=f"{pre}/collect", roles=("collect", "program"),
                fn=trainer.collect, args=(params, key)),
        _ring_program(f"{pre}/ring_collect", trainer, params, key),
        Program(name=f"{pre}/train_aips", roles=("program",),
                fn=train_aips, args=(aips, train_data, agent_keys),
                meta={"feedback": _feed_first}),
        # the fused AIP round: holdout split + eval + train + freshness
        # gate over the ring-resident dataset
        Program(name=f"{pre}/aip_round", roles=("program",),
                fn=trainer.aip_round,
                args=(aips, data, agent_keys, mask, reports, 0, 0),
                meta={"feedback": _feed_aip_round}),
        Program(name=f"{pre}/ials_train", roles=("program",),
                fn=trainer.ials_train, args=(state["ials"], aips),
                meta={"feedback": _feed_first}),
        Program(name=f"{pre}/gs_eval", roles=("program",),
                fn=functools.partial(trainer.gs_eval,
                                     episodes=cfg.eval_episodes),
                args=(params, key)),
    ]


def round_programs(env: str, *, kind: str = "fnn",
                   device="cuda") -> List[Program]:
    """One round of the loop driver, yielding its round record (the
    ``ScalarSyncBudget`` program)."""
    from repro_torch import random as R

    trainer = tiny_trainer(env, kind=kind, device=device, shards=1,
                           outer_rounds=1)

    def one_round():
        _, history = trainer.run(R.key(0, device=trainer.device))
        return history[-1]

    return [Program(name=f"loop/{env}/round", roles=("round",),
                    fn=one_round, meta={"device": str(trainer.device)})]


def stream_programs(env: str = "traffic", *, streams: int = 64,
                    kind: str = "fnn", device="cuda") -> List[Program]:
    """The ring collect at a wide stream count S: the S knob only widens
    a batch axis, so what holds at S=2 must hold at S=64, and the ring's
    in-place claims are what can regress as shapes grow."""
    from repro_torch import random as R

    trainer = tiny_trainer(env, kind=kind, device=device, shards=1,
                           collect_streams=streams)
    key = R.key(0, device=trainer.device)
    params = trainer.init(key)["ials"]["params"]
    return [_ring_program(f"streams/{env}@S{streams}/ring_collect",
                          trainer, params, key)]


def sharded_programs(env: str, *, kind: str = "fnn",
                     device="cuda") -> List[Program]:
    """The sharded round's programs (``ShardedDIALSRunner.
    contract_programs``: the per-shard train body, and the
    region-decomposed collect and eval body) on this process's shard
    mesh, one shard per rank of its process group (one shard without a
    group), from :func:`tiny_trainer`'s state. The GS bodies communicate:
    every rank of a group must build and check them in the same order."""
    from repro_torch import random as R
    from repro_torch.distributed import runtime

    n_shards = runtime.world_size()
    trainer = tiny_trainer(env, kind=kind, device=device, shards=n_shards)
    runner = trainer._sharded_runner(n_shards)
    key = R.key(0, device=trainer.device)
    state = trainer.init(key)
    carry = runner.shard_carry(
        {"aips": state["aips"], "ials": state["ials"],
         "reports": torch.zeros((trainer.info.n_agents,),
                                dtype=torch.int64, device=trainer.device)})
    return runner.contract_programs(carry, key)


def kernel_dtype_programs(dtype=torch.bfloat16, *,
                          device="cuda") -> List[Program]:
    """The GRU and GAE ops as dtype round-trip programs: reduced
    precision in, reduced precision out (the kernels compute in f32 and
    must cast back). The plain versions everywhere; the kernel ops
    (``kernels/{gru,gae}/ops.py``) on a card only, where they launch."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.marl import gae as gae_plain
    from repro_torch.nn import gru as gru_plain

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    a, b, t, d_in, h = 2, 2, 8, 4, 8
    dones = (torch.rand((b, t), generator=gen, device=dev) < 0.2).to(dtype)
    gae_args = (rnd(b, t), rnd(b, t), dones, rnd(b))
    gru_params = {"wi": rnd(a, d_in, 3 * h), "wh": rnd(a, h, 3 * h),
                  "bi": rnd(a, 3 * h), "bh": rnd(a, 3 * h)}
    gru_args = (gru_params, rnd(a, b, t, d_in))
    programs = [
        Program(name="kernels/gae/plain", roles=("dtype",),
                fn=gae_plain.gae, args=gae_args),
        Program(name="kernels/gru/plain", roles=("dtype",),
                fn=gru_plain.gru_sequence, args=gru_args),
    ]
    if dev.type == "cuda":
        from repro_torch.kernels.gae import ops as gae_ops
        from repro_torch.kernels.gru import ops as gru_ops
        programs += [
            Program(name="kernels/gae/kernel", roles=("dtype",),
                    fn=gae_ops.gae, args=gae_args),
            Program(name="kernels/gru/kernel", roles=("dtype",),
                    fn=gru_ops.gru_sequence, args=gru_args),
        ]
    return programs


def all_programs(scenarios: Optional[Iterable[str]] = None,
                 kinds: Iterable[str] = ("fnn",), *,
                 device="cuda") -> List[Program]:
    """Every registered program: the loop driver's pieces (and a round)
    and the sharded round's programs for every scenario x policy kind,
    the kernel dtype programs, the wide-stream ring collect, and anything
    added via :func:`register_programs`."""
    from repro_torch.envs import registry

    scenarios = list(registry.names() if scenarios is None else scenarios)
    out: List[Program] = []
    for env in scenarios:
        for kind in kinds:
            progs = (loop_programs(env, kind=kind, device=device)
                     + round_programs(env, kind=kind, device=device))
            for p in progs:        # the names say which policy kind ran
                p.name = p.name.replace(f"loop/{env}/",
                                        f"loop/{env}[{kind}]/")
            out.extend(progs)
            for p in sharded_programs(env, kind=kind, device=device):
                p.name = p.name.replace(f"sharded/{env}",
                                        f"sharded/{env}({kind})")
                out.append(p)
    out.extend(kernel_dtype_programs(device=device))
    if scenarios:
        out.extend(stream_programs(scenarios[0], device=device))
    for builder in _EXTRA_BUILDERS:
        out.extend(builder(device))
    return out
