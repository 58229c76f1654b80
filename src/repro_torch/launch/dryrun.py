"""Multi-pod dry-run — the port of ``repro/launch/dryrun.py``: run every
(architecture × shape × mesh) cell's step once on a fake process group of
256 or 512 ranks, with fake CUDA tensors, and record memory, cost and
collective numbers for the roofline analysis.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --mesh multi ...

The process starts PyTorch's fake process group (the ``"fake"`` backend of
``torch.testing._internal.distributed.fake_pg.FakeStore``: collectives
return at once, moving nothing) as rank 0 of 256 or 512, builds the
production mesh on ``"cuda"`` and runs the step under ``FakeTensorMode``:
the params, optimizer state, batch and caches are fake tensors (no
memory, no card) laid out as DTensors by the step's shardings, each
holding rank 0's block. A cell PASSES iff the step runs to its end (a
sharding the ops cannot take, or an op with no rule, is a bug).

The record keeps the reference's keys; the port's own reckoning:

* ``memory.argument_bytes`` / ``output_bytes``: the bytes of rank 0's
  blocks of every argument / output, exact.
* ``memory.temp_bytes``: the peak, over the step, of the bytes of the
  storages made by its ops that some op output still holds (the
  arguments are not counted); ``code_bytes`` is None (nothing compiles).
* ``cost.flops``: the FLOPs of the ops each rank runs on its own blocks
  (``torch.utils.flop_counter``'s formulas on the local shapes; DTensor's
  global-shape bookkeeping is not counted); ``bytes_accessed``: the
  inputs plus outputs of each such op; ``transcendentals``: the elements
  out of exp, log, tanh, sigmoid, rsqrt, sin, cos, erf, silu and gelu.
* ``collectives``: ``{bytes, counts, total_bytes}`` by the reference's
  kinds, the result bytes of each ``_c10d_functional`` collective (and
  DTensor's ``shard_dim_alltoall``) a rank issues. ``collective-permute``
  has no DTensor counterpart and stays 0.

The port's steps are Python loops over the repeats, so each op is run and
counted: the cell's numbers come from the same step at 1 and 2 period
repeats (``_scaled_spec``), extrapolated to the full depth by the
reference's two-point rule (``cost_extrapolated``), so a full-depth cell
does not trace every layer. ``cost``, ``collectives`` and the memory
figures other than ``argument_bytes`` are those extrapolated totals;
``argument_bytes`` is the full-depth arguments'.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch

from repro_torch.configs import registry, shapes as shapes_mod
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.tree import leaves, leaves_with_path, tree_map

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "rsqrt", "sin", "cos",
                   "erf", "silu", "gelu", "softplus", "expm1", "log1p")


def init_fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake group of ``world_size`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tensors(tree):
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def _local(x):
    return x.to_local() if mesh_lib.is_dtensor(x) else x


def _nbytes(x) -> int:
    x = _local(x)
    return x.numel() * x.element_size()


class LocalCounter:
    """A dispatch mode that counts the ops run on plain (local) tensors —
    FLOPs, bytes in and out, transcendental elements, collectives by kind
    — and the live bytes of the storages they make. Ops with DTensor
    operands are left to DTensor (which runs its local ops under this
    mode again)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self.mode = None

    def _hold(self, t):
        key = t.untyped_storage()._cdata
        n = self._refs.get(key)
        if n is None:
            size = t.untyped_storage().nbytes()
            self._refs[key] = [1, size]
            self.live += size
            self.peak = max(self.peak, self.live)
        else:
            n[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        n = self._refs.get(key)
        if n is None:
            return
        n[0] -= 1
        if n[0] == 0:
            self.live -= n[1]
            del self._refs[key]

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                counter._count(func, args, kwargs, out)
                return out

        self.mode = _Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)

    def _count(self, func, args, kwargs, out):
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("_c10d_functional", "_dtensor") and name in _KIND:
            kind = _KIND[name]
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(o.numel() * o.element_size()
                                         for o in outs)
        elif ns == "aten":
            packet = func._overloadpacket
            if packet in self.flop_registry:
                self.flops += int(self.flop_registry[packet](
                    *args, **kwargs, out_val=out))
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(o.numel() for o in outs)
        for o in outs:
            if o.device.type != "meta":
                self._hold(o)

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals}

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}


def fake_args(bundle):
    """The bundle's arguments as DTensors of fake tensors on the mesh's
    device type, holding rank 0's block (call under a
    ``FakeTensorMode``); an index spec becomes 0."""
    from torch.distributed.tensor import DTensor

    def one(spec, sh):
        if spec is None:                      # no shared-block cache
            return None
        if spec.ndim == 0 and spec.dtype == torch.int32 \
                and sh.spec == ():
            return 0
        sh = sh.padded(spec.ndim)
        local = torch.empty(sh.shard_shape(spec.shape), dtype=spec.dtype,
                            device=sh.mesh.device_type)
        return DTensor.from_local(
            local, sh.mesh, sh.placements, run_check=False,
            shape=spec.shape,
            stride=torch.empty(spec.shape, device="meta").stride())

    return tuple(tree_map(one, spec_tree, sh_tree)
                 for spec_tree, sh_tree in zip(bundle.arg_specs,
                                               bundle.shardings))


def argument_bytes(bundle) -> int:
    """The bytes of rank 0's blocks of every argument (exact, from the
    shardings: no tensor is made)."""
    total = 0
    for spec_tree, sh_tree in zip(bundle.arg_specs, bundle.shardings):
        specs = leaves(spec_tree)
        shs = leaves(sh_tree) if not isinstance(
            sh_tree, mesh_lib.NamedSharding) else [sh_tree]
        for spec, sh in zip(specs, shs):
            if spec is None:                  # no shared-block cache
                continue
            shape = sh.padded(spec.ndim).shard_shape(spec.shape)
            total += spec.dtype.itemsize * _prod(shape)
    return total


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def run_step(bundle, *, warm: bool = True) -> dict:
    """One fake run of the step, after a warm-up run unless ``warm`` is
    False (DTensor's sharding propagation runs each op once on
    global-shape fake tensors; cached, it is not counted; a step whose ops
    an earlier run already propagated needs no warm-up): cost,
    collectives, temp and output bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        if warm:
            bundle.fn(*fake_args(bundle))
        args = fake_args(bundle)
        counter = LocalCounter()
        with counter:
            out = bundle.fn(*args)
        out_bytes = sum(_nbytes(x) for x in _tensors(out))
        del out
    return {"cost": counter.cost(), "collectives": counter.collectives(),
            "temp_bytes": counter.peak, "output_bytes": out_bytes}


def _scaled_spec(spec, repeats: int):
    """Same architecture with the depth truncated to ``repeats`` period
    applications (the two-point cost extrapolation)."""
    dc = dataclasses
    if spec.kind == "encdec":
        dec = dc.replace(spec.cfg.decoder,
                         n_layers=repeats * len(spec.cfg.decoder.period),
                         scan_unroll=True)
        enc_l = repeats * len(spec.cfg.encoder_period)
        cfg = dc.replace(spec.cfg, decoder=dec, encoder_layers=enc_l)
    else:
        cfg = dc.replace(spec.cfg, n_layers=repeats * len(spec.cfg.period),
                         scan_unroll=True)
    return dc.replace(spec, cfg=cfg)


def _full_repeats(spec) -> int:
    if spec.kind == "encdec":
        dec = spec.cfg.decoder
        enc = spec.cfg.encoder_repeats
        assert dec.repeats == enc, "extrapolation needs equal enc/dec repeats"
        return dec.repeats
    return spec.cfg.repeats


def _measure(spec, shape, mesh, kw, warm=True) -> dict:
    m = run_step(steps_mod.make_step(spec, shape, mesh, **kw), warm=warm)
    return {"flops": m["cost"]["flops"],
            "bytes_accessed": m["cost"]["bytes_accessed"],
            "transcendentals": m["cost"]["transcendentals"],
            "collective_bytes": m["collectives"]["total_bytes"],
            "temp_bytes": m["temp_bytes"], "output_bytes": m["output_bytes"],
            "collectives": m["collectives"]}


def _extrapolate(c1, c2, r_full):
    return c1 + (r_full - 1) * (c2 - c1)


def extrapolated_cost(spec, shape, mesh, kw) -> tuple:
    """The step at 1 and 2 period repeats; the difference is one repeat,
    so total(R) = c(1) + (R - 1) * (c(2) - c(1)). Returns the
    reference's ``cost_extrapolated`` dict and the extrapolated
    memory and collective figures."""
    r_full = _full_repeats(spec)
    c1 = _measure(_scaled_spec(spec, 1), shape, mesh, kw)
    # a second repeat runs the first's ops on the same shapes: propagated
    c2 = _measure(_scaled_spec(spec, 2), shape, mesh, kw, warm=False)
    out = {}
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        body = c2[k] - c1[k]
        out[k] = c1[k] + (r_full - 1) * body
        out[k + "_body"] = body
    out["repeats"] = r_full
    full = {k: _extrapolate(c1[k], c2[k], r_full)
            for k in ("transcendentals", "temp_bytes", "output_bytes")}
    coll = {part: {k: _extrapolate(c1["collectives"][part][k],
                                   c2["collectives"][part][k], r_full)
                   for k in COLLECTIVES}
            for part in ("bytes", "counts")}
    coll["total_bytes"] = sum(coll["bytes"].values())
    full["collectives"] = coll
    return out, full


def model_flops(spec, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for train, 2·N·D for inference, with N
    the parameters minus the embedding table, counted as the reference
    counts them (its MoE scaling reads a "moe" key, which no params path
    holds, so every expert counts in full)."""
    sds = steps_mod.param_sds(spec)
    cfgs = [spec.cfg.decoder] if spec.kind == "encdec" else [spec.cfg]
    moe_cfgs = [b.moe for c in cfgs for b in c.period if b.moe is not None]
    total = 0.0
    for path, leaf in leaves_with_path(sds):
        names = [str(k) for k in path if isinstance(k, str)]
        size = float(leaf.numel())
        if "embed" in names and leaf.ndim == 2:
            continue                                   # lookup is not a matmul
        if moe_cfgs and any(n in ("up", "down", "gate") for n in names) \
                and "moe" in names:
            m = moe_cfgs[0]
            size *= m.top_k / m.num_experts
        total += size
    factor = 6.0 if shape.kind == "train" else 2.0
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    return factor * total * tokens


def variant_kwargs(spec, shape, variant: str):
    """(spec, step kwargs) of a named variant (``launch.variants``)."""
    if variant == "baseline":
        return spec, {}
    from repro_torch.launch import variants
    kw = variants.VARIANTS[variant](spec, shape)
    return kw.pop("spec", spec), kw


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             variant: str = "baseline", spec=None, shape=None,
             device: str = "cuda") -> dict:
    """One cell's record. ``spec`` and ``shape`` override the registry's
    (reduced cells in tests); ``device`` is the fake tensors' device type
    (a CPU-only build of torch refuses some ops on fake CUDA tensors)."""
    spec = spec or registry.get(arch)
    shape = shape or shapes_mod.SHAPES[shape_name]
    supported, reason = registry.cell_supported(spec, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "status": "skip", "reason": reason}
    if not supported:
        return rec
    if shape.kind == "decode" and not spec.has_decode:
        rec["reason"] = "no decode step for this arch"
        return rec

    multi = mesh_kind == "multi"
    init_fake_group(512 if multi else 256)
    mesh = launch_mesh.make_production_mesh(multi_pod=multi,
                                            device_type=device)
    t0 = time.time()
    spec, kw = variant_kwargs(spec, shape, variant)
    bundle = steps_mod.make_step(spec, shape, mesh, **kw)
    arg_bytes = argument_bytes(bundle)
    t_build = time.time() - t0
    t0 = time.time()
    cost_x, full = extrapolated_cost(spec, shape, mesh, kw)
    t_run = time.time() - t0
    rec.update({
        "status": "ok",
        "kind": bundle.kind,
        "n_devices": mesh.size(),
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": full["output_bytes"],
            "temp_bytes": full["temp_bytes"],
            "code_bytes": None,
        },
        "cost": {"flops": cost_x["flops"],
                 "bytes_accessed": cost_x["bytes_accessed"],
                 "transcendentals": full["transcendentals"]},
        "collectives": full["collectives"],
        "cost_extrapolated": cost_x,
        "model_flops_global": model_flops(spec, shape),
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device type (cpu where torch "
                         "has no CUDA build)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s) for a in registry.list_archs()
              for s in shapes_mod.SHAPES]
             if args.all else [(args.arch, args.shape)])

    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{args.mesh}__{args.variant}"
        try:
            rec = run_cell(arch, shape, args.mesh, variant=args.variant,
                           device=args.device)
        except Exception as e:  # a failing cell is a bug — surface it
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "variant": args.variant, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-6000:]}
            failures += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        line = {k: rec.get(k) for k in
                ("arch", "shape", "mesh", "status", "reason", "compile_s")}
        print(json.dumps(line), flush=True)
        if rec["status"] == "ok":
            print(f"  mem(temp)={rec['memory']['temp_bytes']/2**30:.2f}GiB/dev"
                  f"  flops/dev={rec['cost']['flops']:.3e}"
                  f"  coll={rec['collectives']['total_bytes']/2**30:.3f}GiB",
                  flush=True)
    if failures:
        raise SystemExit(f"{failures} cells FAILED")


if __name__ == "__main__":
    main()
