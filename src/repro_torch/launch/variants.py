"""The DIALS half of ``repro/launch/variants.py``: named MARL scenarios,
the ``DIALS_*`` process-group launcher and the runtime knobs behind the
``--shards`` / ``--async-collect`` / ``--sharded-gs`` / ``--streams``
flags of the port's benchmarks and examples.

The reference's LM half (``VARIANTS``, the sharding rule tables such as
``DECODE_TP2D_RULES``, built on ``repro/distributed/mesh.py``) waits for
the LM mesh, ROADMAP queue 1 item 12d; nothing here refers to it.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# §DIALS MARL scenarios: named (env, side) cells resolved through
# repro_torch.envs.registry, so launch scripts and benchmarks name a
# scenario instead of hardcoding an env module.
# ---------------------------------------------------------------------------
MARL_SCENARIOS = {
    "traffic-2x2": ("traffic", 2),
    "traffic-4x4": ("traffic", 4),
    "traffic-5x5": ("traffic", 5),
    "warehouse-2x2": ("warehouse", 2),
    "warehouse-4x4": ("warehouse", 4),
    "warehouse-5x5": ("warehouse", 5),
    "powergrid-ring4": ("powergrid", 2),
    "powergrid-ring16": ("powergrid", 4),
    "supplychain-line4": ("supplychain", 2),
    "supplychain-line16": ("supplychain", 4),
}


def marl_scenario(name, **overrides):
    """Resolve a named scenario to ``(env_module, env_cfg)``.

    ``overrides`` are env-config field overrides (e.g. ``horizon=32``).
    """
    from repro_torch.envs import registry
    env_name, side = MARL_SCENARIOS[name]
    return registry.make(env_name, side=side, **overrides)


def launch_group(argv, *, processes, local_devices=None, env=None,
                 cwd=None, stdout=None, stderr=None):
    """Start ``processes`` ranks of one gloo group running ``argv``,
    wired through the ``DIALS_*`` bootstrap contract
    (``repro_torch.distributed.bootstrap``): a free coordinator port is
    picked, every child gets its rank/count/coordinator env vars
    (``BootstrapConfig.env()``), and each child's own
    ``bootstrap.bootstrap()`` call joins the group. ``local_devices``
    may only be None or 1: the port runs one shard per process. Returns
    the ``subprocess.Popen`` handles in rank order; the caller owns
    waiting and exit-code policy."""
    import os
    import subprocess

    from repro_torch.distributed import bootstrap

    port = bootstrap.free_port()
    procs = []
    for rank in range(processes):
        cfg = bootstrap.BootstrapConfig(
            coordinator=f"127.0.0.1:{port}", num_processes=processes,
            process_id=rank, local_devices=local_devices)
        procs.append(subprocess.Popen(
            argv, env={**(env if env is not None else os.environ),
                       **cfg.env()},
            cwd=cwd, stdout=stdout, stderr=stderr))
    return procs


def dials_variant_for(shards, async_collect=False, sharded_gs="auto",
                      streams=None):
    """``DIALSConfig`` overrides for the runtime flags. ``shards``:
    ``None`` = auto (the sharded round iff the process group has more
    than one rank), ``1`` = the loop path, ``N`` = N shards, one per rank
    of an N-rank group. ``async_collect`` overlaps round k+1's GS collect
    with round k's inner steps (one-round dataset lag, bounded by
    ``max_aip_staleness``). ``sharded_gs`` selects the region-decomposed
    GS collect/eval (``repro_torch.core.gs_sharded``): auto = whenever
    the env's partition tiles the shard count, on/off force.
    ``streams``: the collect width S, ``DIALSConfig.collect_streams``
    (None keeps ``collect_envs``)."""
    out = {"shards": shards, "async_collect": async_collect,
           "sharded_gs": sharded_gs}
    if streams is not None:
        out["collect_streams"] = int(streams)
    return out
