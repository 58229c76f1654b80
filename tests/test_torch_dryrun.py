"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's values computed without devices, and its runs on a fake
256-rank group (in subprocesses: a fake group must not outlive them).

* Exact, every supported (arch × shape) cell on both production meshes:
  ``argument_bytes`` against the sum of the reference's
  ``NamedSharding(AbstractMesh, spec).shard_shape(shape)`` bytes of its
  param, optimizer and batch (decode: token, cache and index) leaves;
  ``model_flops_global`` against the reference's ``model_flops``; the
  skip set against the reference's ``cell_supported``.
* Reduced cells of every architecture run to their end on the fake mesh
  (``tests/test_torch_dryrun_cells_{a,b}.py``).
* ``collectives`` and ``cost`` on a hand-built DTensor program whose
  collectives and FLOPs are known.
* The ``roofline`` bench of ``benchmarks/torch_run.py`` over port
  records, with the H100 constants.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh, NamedSharding

from repro.configs import registry as jregistry, shapes as jshapes
from repro.distributed import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro_torch.configs import registry, shapes
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import dryrun, steps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": mesh_lib.AbstractMesh((16, 16), ("data", "model")),
          "multi": mesh_lib.AbstractMesh((2, 16, 16),
                                         ("pod", "data", "model"))}
CELLS = [(a, s) for a in sorted(registry.ARCHS) for s in shapes.SHAPES]
# the port's LM AdamW step counter is int64 (the reference's int32): a
# train cell's arguments carry 4 bytes more
STEP_EXTRA = {"train": 4, "prefill": 0, "decode": 0}


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "JAX_PLATFORMS": "cpu"}


def _jmesh(m):
    try:
        return JAbstractMesh(m.sizes, m.names)
    except TypeError:
        return JAbstractMesh(tuple(zip(m.names, m.sizes)))


@functools.lru_cache(maxsize=None)
def _ref_model_flops():
    """The reference's ``model_flops`` of every cell, in a subprocess
    (importing ``repro.launch.dryrun`` forces 512 host devices)."""
    code = (
        "import json\n"
        "from repro.configs import registry, shapes\n"
        "from repro.launch import dryrun\n"
        "print(json.dumps({f'{a}|{s}': dryrun.model_flops(registry.get(a), "
        "shapes.SHAPES[s]) for a in registry.list_archs() "
        "for s in shapes.SHAPES}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _ref_param_sds(arch):
    return jsteps.param_sds(jregistry.get(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache_sds(arch, shape_name):
    return jsteps.cache_sds(jregistry.get(arch), jshapes.SHAPES[shape_name])


def _ref_param_shardings(arch, jm, **kw):
    """The reference's ``steps.param_shardings`` on its cached shapes."""
    spec, sds = jregistry.get(arch), _ref_param_sds(arch)
    return jmesh.logical_to_sharding(japi.logical_specs(spec), sds, jm,
                                     **kw), sds


def _ref_arg_bytes(arch, shape_name, mesh):
    """The reference's arguments of the cell's step, their shard bytes on
    the abstract mesh, from its own sharding builders."""
    spec, shape = jregistry.get(arch), jshapes.SHAPES[shape_name]
    jm = _jmesh(mesh)
    if shape.kind == "decode":
        long_ctx = shape.name.startswith("long")
        rules = jmesh.LONG_CONTEXT_RULES if long_ctx else jmesh.DECODE_RULES
        p_sh, p_sds = _ref_param_shardings(arch, jm, rules=rules,
                                           fsdp_axes=())
        c_sds = _ref_cache_sds(arch, shape_name)
        c_sh = jsteps.cache_shardings(spec, jm, c_sds, rules=rules)
        tok = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
        tok_sh = jsteps._batch_shardings(tok, jm, long_context=long_ctx)
        idx = jax.ShapeDtypeStruct((), jnp.int32)
        pairs = [(p_sds, p_sh), (tok, tok_sh), (c_sds, c_sh),
                 (idx, NamedSharding(jm, jax.sharding.PartitionSpec()))]
    else:
        p_sh, p_sds = _ref_param_shardings(arch, jm, rules=jmesh.TRAIN_RULES,
                                           fsdp_axes=("pod", "data"))
        b_sds = jregistry.input_specs(spec, shape)
        pairs = [(p_sds, p_sh), (b_sds, jsteps._batch_shardings(b_sds, jm))]
        if shape.kind == "train":
            pairs.append(jsteps.opt_shardings(spec, jm, p_sh, p_sds)[::-1])
    total = 0
    for sds, sh in pairs:
        for x, s in zip(jax.tree.leaves(sds), jax.tree.leaves(
                sh, is_leaf=lambda v: isinstance(v, NamedSharding))):
            total += int(np.prod(s.shard_shape(x.shape))) * \
                jnp.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_cells_match_reference(arch, mesh_kind):
    """Every shape of the architecture: the skip set, then for each
    supported cell the argument bytes and the model FLOPs, exact."""
    mesh = MESHES[mesh_kind]
    ref_flops = _ref_model_flops()
    for shape_name, shape in shapes.SHAPES.items():
        spec = registry.get(arch)
        ok, reason = registry.cell_supported(spec, shape)
        assert (ok, reason) == jregistry.cell_supported(
            jregistry.get(arch), jshapes.SHAPES[shape_name])
        if not ok or (shape.kind == "decode" and not spec.has_decode):
            continue
        bundle = steps.make_step(spec, shape, mesh)
        assert dryrun.argument_bytes(bundle) == _ref_arg_bytes(
            arch, shape_name, mesh) + STEP_EXTRA[shape.kind], shape_name
        assert dryrun.model_flops(spec, shape) == \
            ref_flops[f"{arch}|{shape_name}"], shape_name


_KNOWN = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard, Replicate
from repro_torch.launch import dryrun, mesh as lm
dryrun.init_fake_group(256)
mesh = lm.make_production_mesh(device_type="cpu")
with FakeTensorMode():
    def prog():
        x = DTensor.from_local(torch.empty(4, 64), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        w = DTensor.from_local(torch.empty(64, 32), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        y = x @ w                       # local (4, 64) @ (64, 32), partial
        return y.redistribute(mesh, [Shard(0), Replicate()]), \
            x.redistribute(mesh, [Replicate(), Shard(1)])
    prog()                              # sharding propagation, cached
    c = dryrun.LocalCounter()
    with c:
        prog()
print(json.dumps({"coll": c.collectives(), "cost": c.cost()}))
"""


def test_counter_on_a_known_program():
    """x (64, 1024) split (data, model) times w (1024, 32) split along its
    rows over model: each rank multiplies its (4, 64) block by (64, 32)
    (2*4*64*32 FLOPs), the partial sum is all-reduced over model (4*32
    floats), and gathering x over data is one all-gather of (64, 64)."""
    out = subprocess.run([sys.executable, "-c", _KNOWN], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    coll, cost = rec["coll"], rec["cost"]
    assert coll["counts"] == {"all-gather": 1, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["bytes"]["all-reduce"] == 4 * 32 * 4
    assert coll["bytes"]["all-gather"] == 64 * 64 * 4
    assert coll["total_bytes"] == 4 * 32 * 4 + 64 * 64 * 4
    assert cost["flops"] == 2 * 4 * 64 * 32


def test_roofline_bench_over_port_records(tmp_path, monkeypatch):
    from benchmarks import torch_roofline, torch_run
    d = tmp_path / "experiments" / "dryrun_torch"
    d.mkdir(parents=True)
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "single",
           "variant": "baseline", "status": "ok",
           "cost": {"flops": 9.89e14, "bytes_accessed": 6.7e12},
           "collectives": {"total_bytes": 9.0e11}}
    (d / "tinyllama-1.1b__train_4k__single__baseline.json").write_text(
        json.dumps(rec))
    (d / "x__y__single__baseline.json").write_text(
        json.dumps({"arch": "x", "status": "FAIL"}))
    monkeypatch.chdir(tmp_path)
    assert torch_run.main(["--device", "cpu", "--only", "roofline"]) == 0
    rows = json.loads((tmp_path / "experiments" / "bench" /
                       "torch_roofline.json").read_text())
    rows = rows["rows"] if isinstance(rows, dict) else rows
    assert len(rows) == 1
    row = rows[0]
    assert row["label"] == "tinyllama-1.1b__train_4k__single__baseline"
    assert set(row) >= {"arch", "shape", "mesh", "variant", "compute_s",
                        "memory_s", "collective_s", "bottleneck", "step_s",
                        "roofline_fraction"}
    assert row["compute_s"] == pytest.approx(1.0)       # 9.89e14 / 989e12
    assert row["memory_s"] == pytest.approx(2.0)        # 6.7e12 / 3.35e12
    assert row["collective_s"] == pytest.approx(2.0)    # 9e11 / 450e9
    assert row["bottleneck"] == "memory" and row["step_s"] == \
        pytest.approx(2.0)
    assert (torch_roofline.PEAK_FLOPS, torch_roofline.HBM_BW,
            torch_roofline.NVLINK_BW) == (989e12, 3.35e12, 450e9)
