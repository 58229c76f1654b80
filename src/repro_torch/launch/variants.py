"""Named sharding/step variants — the port of ``repro/launch/variants.py``.

The LM half: each variant maps (spec, shape) -> kwargs for
``launch.steps.make_step``; the dry-run's ``--variant`` flag selects one,
so every hypothesis in the hillclimb log is a reproducible command line.
The DIALS half: named MARL scenarios, the ``DIALS_*`` process-group
launcher and the runtime knobs behind the ``--shards`` /
``--async-collect`` / ``--sharded-gs`` / ``--streams`` flags of the
port's benchmarks and examples.
"""
from __future__ import annotations

import dataclasses as dc

from repro_torch.distributed import mesh as mesh_lib

# 2D tensor-parallel decode: weights split over BOTH mesh axes (model
# major; no per-step weight all-gather), batch replicated, cache
# sequence-split.
DECODE_TP2D_RULES: mesh_lib.Rules = (
    ("batch", None),
    ("cache_batch", ("pod", "data")),
    ("cache_seq", "model"),
    ("vocab", ("model", "data")),
    ("heads", ("model", "data")),
    ("kv_heads", ("model", "data")),
    ("mlp", ("model", "data")),
    ("expert", "model"),
    ("embed", None),
    ("layers", None),
    ("seq", None),
)


def _decode_tp2d(spec, shape):
    return {"rules": DECODE_TP2D_RULES, "fsdp_axes": ()}


def _train_no_fsdp(spec, shape):
    # pure TP+DP: params replicated over data (baseline ablation)
    return {"fsdp_axes": ()}


def _decode_gathered(spec, shape):
    # pre-optimization decode baseline: each rank reads its rows' whole
    # K/V cache instead of running the distributed softmax.
    return {"sharded_softmax": False}


def _decode_fsdp(spec, shape):
    # weight-gathered decode (capacity-first): ZeRO-split weights,
    # all-gathered per step — the baseline for big-model serving memory
    return {"fsdp_axes": ("pod", "data")}


def _replace_moe(spec, **moe_kw):
    """Rebuild an ArchSpec with every MoE block's config modified."""
    def fix_cfg(cfg):
        period = tuple(
            dc.replace(b, moe=dc.replace(b.moe, **moe_kw))
            if b.moe is not None else b for b in cfg.period)
        return dc.replace(cfg, period=period)

    if spec.kind == "encdec":
        cfg = dc.replace(spec.cfg, decoder=fix_cfg(spec.cfg.decoder))
    else:
        cfg = fix_cfg(spec.cfg)
    return dc.replace(spec, cfg=cfg)


def _moe_dense(spec, shape):
    # the one-hot dispatch of the reference (the port computes it as a
    # row scatter and gather: same result)
    return {"spec": _replace_moe(spec, dispatch="dense")}


def _moe_gather(spec, shape):
    # scatter/gather MoE dispatch
    return {"spec": _replace_moe(spec, dispatch="gather")}


def _moe_gather_sharded(spec, shape):
    # group-local routing/capacity (16 groups = the data axis)
    return {"spec": _replace_moe(spec, dispatch="gather", token_shards=16)}


def _train_pod_local_fsdp(spec, shape):
    # FSDP only WITHIN a pod; across pods, parameters are replicated and
    # reconciled every F steps by the DIALS-outer optimizer — the per-step
    # train program carries no cross-pod collective.
    return {"fsdp_axes": ("data",)}


def _remat_dots(spec, shape):
    # keep only matmul outputs instead of full-repeat recompute
    if spec.kind == "encdec":
        cfg = dc.replace(spec.cfg,
                         decoder=dc.replace(spec.cfg.decoder, remat="dots"))
    else:
        cfg = dc.replace(spec.cfg, remat="dots")
    return {"spec": dc.replace(spec, cfg=cfg)}


# Pure ZeRO-3 data parallelism: batch over every mesh axis, no tensor
# parallelism at all. Weights/optimizer fully split over all ranks and
# all-gathered layer by layer.
ZERO3_RULES: mesh_lib.Rules = (
    ("batch", ("pod", "data", "model")),
    ("vocab", None),
    ("heads", None),
    ("kv_heads", None),
    ("mlp", None),
    ("expert", None),
    ("embed", None),
    ("layers", None),
    ("seq", None),
    ("cache_batch", ("pod", "data", "model")),
    ("cache_seq", None),
)


def _train_zero3(spec, shape):
    return {"rules": ZERO3_RULES,
            "fsdp_axes": ("pod", "data", "model"),
            "seq_parallel": False,
            "batch_axes": ("pod", "data", "model")}


def _train_zero3_mb8(spec, shape):
    # zero3 + 8-way gradient accumulation: activation memory /8
    return {**_train_zero3(spec, shape), "microbatches": 8}


def _train_zero3_dots(spec, shape):
    # zero3 + dots-remat
    cfg = dc.replace(spec.cfg, remat="dots")
    return {**_train_zero3(spec, shape), "spec": dc.replace(spec, cfg=cfg)}


def _train_no_seqpar(spec, shape):
    # ablation: drop the sequence-parallel residual constraint
    return {"seq_parallel": False}


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


VARIANTS = {
    "train_no_seqpar": _train_no_seqpar,
    "train_zero3": _train_zero3,
    "train_zero3_dots": _train_zero3_dots,
    "train_zero3_mb8": _train_zero3_mb8,
    "decode_tp2d": _decode_tp2d,
    "decode_gathered": _decode_gathered,
    "train_no_fsdp": _train_no_fsdp,
    "decode_fsdp": _decode_fsdp,
    "moe_dense": _moe_dense,
    "moe_gather": _moe_gather,
    "moe_gather_sharded": _moe_gather_sharded,
    "train_pod_local_fsdp": _train_pod_local_fsdp,
    "remat_dots": _remat_dots,
}
