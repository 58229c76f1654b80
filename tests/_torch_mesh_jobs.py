"""Rank jobs of the LM mesh tests (``tests/test_torch_mesh_*.py``): four
gloo ranks on the CPU as a (data=2, model=2) DeviceMesh, started by
``repro_torch.distributed.bootstrap.spawn_local``. A rank imports this
module to find its job, so it imports no JAX. Each job holds the mesh
against the single-device port on the same weights and inputs and
returns the largest error (relative to max(1, |single-device value|))
of each comparison."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.configs import registry, shapes
from repro_torch.distributed import bootstrap, fault, mesh as mesh_lib
from repro_torch.launch import mesh as launch_mesh, steps, variants
from repro_torch.optim import adamw
from repro_torch.tree import leaves

ARCH = "tinyllama-1.1b"
# the train variants of launch.variants (and the baseline rules), in two
# groups, one a test file (each group a spawn of its own)
TP_VARIANTS = ("baseline", "train_no_seqpar", "train_no_fsdp",
               "train_pod_local_fsdp")
ZERO3_VARIANTS = ("train_zero3", "train_zero3_dots", "train_zero3_mb8")


def f32(spec):
    """``spec`` with every config dtype set to float32."""
    def layer(ls):
        subs = {n: dataclasses.replace(getattr(ls, n), dtype=torch.float32)
                for n in ("attn", "ssm", "mlp", "moe")
                if getattr(ls, n) is not None}
        return dataclasses.replace(ls, dtype=torch.float32, **subs)
    cfg = spec.cfg
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        cfg, dtype=torch.float32, period=tuple(layer(x) for x in cfg.period),
        shared=cfg.shared and layer(cfg.shared)))


def rel(a, b) -> float:
    a = a.full_tensor() if mesh_lib.is_dtensor(a) else a
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def block_index(spec, coords: dict, mesh) -> tuple:
    """Which block of each tensor dim the device at mesh coordinates
    ``coords`` (axis name -> index) holds under ``spec``: the spec's axes
    in its own order, the first major (the layout of a JAX
    ``NamedSharding``)."""
    shape = mesh_lib.mesh_shape(mesh)
    out = []
    for entry in spec:
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = 0
        for a in axes:
            idx = idx * shape[a] + coords[a]
        out.append(idx)
    return tuple(out)


def _opt(params):
    """AdamW state at step 100 (a non-zero learning rate)."""
    opt = adamw.init(params, per_agent=False)
    return {**opt, "step": torch.full_like(opt["step"], 100)}


def _mesh():
    torch.set_num_threads(1)            # four ranks share the host's cores
    bootstrap.bootstrap()
    return launch_mesh.make_group_mesh((2, 2), ("data", "model"),
                                       device_type="cpu")


def train_variants(names):
    """One train step of each named train variant of ``launch.variants``
    (or the baseline rules) on the mesh against one device: loss, grad
    norm and every updated param. One layer of the reduced config."""
    import time
    mesh = _mesh()
    base = f32(registry.get(ARCH, reduced=True))
    base = dataclasses.replace(base, cfg=dataclasses.replace(base.cfg,
                                                             n_layers=1))
    shape = shapes.Shape("train_4k", 16, 32, "train")
    params = steps.init_params(base, seed=0, device="cpu")
    batch = registry.concrete_inputs(R.key(1, device="cpu"), base, shape)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        kw = {} if name == "baseline" else variants.VARIANTS[name](base,
                                                                   shape)
        spec = kw.pop("spec", base)
        one = steps.make_train_step(spec, shape,
                                    microbatches=kw.get("microbatches", 1))
        p1, _, m1 = one(params, _opt(params), batch)
        bundle = steps.make_train_step(spec, shape, mesh, **kw)
        p, o, b = bundle.place(params, _opt(params), batch)
        p2, _, m2 = bundle.fn(p, o, b)
        out[name] = (max([rel(m2[k], m1[k]) for k in ("loss", "grad_norm")]
                         + [rel(x, y) for x, y in zip(leaves(p2),
                                                      leaves(p1))]),
                     time.perf_counter() - t0)
    return out


def serve():
    """The prefill, four decode steps with and without the distributed
    softmax, ``shard_batch``, ``reshard`` from (2, 2) to (4, 1) and back,
    and the layout of a dim split model-major (``_StridedShard``)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.data import pipeline
    mesh = _mesh()
    spec = f32(registry.get(ARCH, reduced=True))
    pshape = shapes.Shape("prefill_32k", 16, 4, "prefill")
    dshape = shapes.Shape("decode_32k", 16, 4, "decode")
    params = steps.init_params(spec, seed=0, device="cpu")
    batch = registry.concrete_inputs(R.key(1, device="cpu"), spec, pshape)
    out = {}
    want = steps.make_prefill_step(spec)(params, batch)
    bundle = steps.make_prefill_step(spec, pshape, mesh)
    out["prefill"] = rel(bundle.fn(*bundle.place(params, batch)), want)
    tokens = batch["tokens"][:, :4].to(torch.int32)
    caches = steps.build_caches(params, spec, dshape)
    one = steps.make_serve_step(spec)
    want = [one(params, tokens[:, i:i + 1], caches, i)[0] for i in range(4)]
    for name, sharded in (("decode_sharded", True),
                          ("decode_gathered", False)):
        sb = steps.make_serve_step(spec, dshape, mesh,
                                   sharded_softmax=sharded)
        p, _, c, _ = sb.place(params, None,
                              steps.build_caches(params, spec, dshape), 0)
        errs = []
        for i in range(4):
            tok = sb.place(None, tokens[:, i:i + 1], None, 0)[1]
            lg, c = sb.fn(p, tok, c, i)
            errs.append(rel(lg, want[i]))
        out[name] = max(errs)
        out[name + "_cache_split"] = str(c["layers"][0]["k"].placements)
    placed = pipeline.shard_batch(batch, mesh)
    out["shard_batch"] = all(
        x.placements == (Shard(0), Replicate())
        and torch.equal(x.full_tensor(), batch[k]) for k, x in placed.items())
    # reshard the params from (data=2, model=2) to (data=4, model=1) and
    # back: every value equal
    logical = steps.api.logical_specs(spec)
    on22 = fault.reshard(params, logical, mesh)
    mesh41 = launch_mesh.make_group_mesh((4, 1), ("data", "model"),
                                         device_type="cpu")
    on41 = fault.reshard(on22, logical, mesh41,
                         fsdp_axes=("pod", "data"))
    back = fault.reshard(on41, logical, mesh)
    out["reshard"] = all(
        torch.equal(a.full_tensor(), x) and torch.equal(b.full_tensor(), x)
        and a.device_mesh is mesh41 and b.placements == c.placements
        for a, b, c, x in zip(leaves(on41), leaves(back), leaves(on22),
                              leaves(params)))
    # a dim split ("model", "data"): the rank at (data=d, model=m) holds
    # block m * 2 + d, as a JAX mesh lays it out
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    sh = mesh_lib.NamedSharding(mesh, (("model", "data"), None))
    x = mesh_lib.distribute(full, sh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    blk = block_index(sh.spec, coord, mesh)[0]
    out["strided"] = torch.equal(x.to_local(), full[blk * 2:(blk + 1) * 2]) \
        and torch.equal(x.full_tensor(), full) \
        and mesh_lib.block_offset(x, 0) == blk * 2
    return out


def outer_pods(anchor, pods, int8: bool):
    """One DIALS-outer sync over a (pod=2) mesh of two ranks: rank p holds
    pod p's params (numpy trees in, numpy out) and the anchor's state."""
    import numpy as np
    from repro_torch.optim import outer
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    ctx = bootstrap.bootstrap()
    mesh = launch_mesh.make_group_mesh((2,), ("pod",), device_type="cpu")
    to_t = lambda tree: tree_map(lambda x: torch.tensor(np.asarray(x)),
                                 tree)
    local = to_t(pods[ctx.process_id])
    new, state, err = outer.outer_step(
        local, outer.init(to_t(anchor)),
        outer.OuterConfig(compress_int8=int8), pod_axis="pod", mesh=mesh)
    return {"params": new, "state": state, "err": err}
