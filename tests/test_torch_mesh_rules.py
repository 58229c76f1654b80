"""The logical-axis sharding rules of ``repro_torch.distributed.mesh``
against ``repro.distributed.mesh``: every case of ``tests/test_mesh_rules.py``
on the port, then a property over random logical tuples and dims (the
port's spec equals the reference's ``resolve_spec`` on the AbstractMesh
SINGLE and MULTI meshes), and the production meshes on a fake group."""
import os
import subprocess
import sys

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # dev extra absent: property tests skip
    from _hypothesis_stub import given, settings, st

from jax.sharding import AbstractMesh as JAbstractMesh

from repro.distributed import mesh as jmesh
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import variants

from _torch_mesh_jobs import block_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SINGLE = mesh_lib.AbstractMesh((16, 16), ("data", "model"))
MULTI = mesh_lib.AbstractMesh((2, 16, 16), ("pod", "data", "model"))


def _jmesh(m):
    try:
        return JAbstractMesh(m.sizes, m.names)
    except TypeError:
        return JAbstractMesh(tuple(zip(m.names, m.sizes)))


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def _axes_used(spec):
    used = []
    for s in spec:
        if s is None:
            continue
        used.extend((s,) if isinstance(s, str) else list(s))
    return used


def test_basic_rules_single_pod():
    spec = mesh_lib.resolve_spec(("embed", "mlp"), (1024, 4096), SINGLE,
                                 mesh_lib.TRAIN_RULES)
    assert spec == (None, "model")


def test_divisibility_fallback():
    spec = mesh_lib.resolve_spec(("cache_batch", "kv_heads"), (256, 8),
                                 SINGLE, mesh_lib.TRAIN_RULES)
    assert spec[1] is None


def test_no_mesh_axis_used_twice():
    spec = mesh_lib.resolve_spec(("heads", "kv_heads"), (64, 16), SINGLE,
                                 mesh_lib.TRAIN_RULES)
    used = _axes_used(spec)
    assert len(used) == len(set(used))


def test_multi_axis_target():
    spec = mesh_lib.resolve_spec(("batch", "seq"), (256, 4096), MULTI,
                                 mesh_lib.TRAIN_RULES)
    assert spec[0] == ("pod", "data")


def test_multi_axis_prefix_fallback():
    spec = mesh_lib.resolve_spec(("batch",), (2,), MULTI,
                                 mesh_lib.TRAIN_RULES)
    assert spec[0] == "pod"


@pytest.mark.parametrize("logical,shape,fsdp,want", [
    (("embed", "mlp"), (1024, 4096), ("data",), ("data", "model")),
    (("mlp",), (4096,), ("data",), ("model",)),
    (("embed", "mlp"), (10, 4096), ("data",), (None, "model")),
])
def test_fsdp_augment(logical, shape, fsdp, want):
    sh = mesh_lib.logical_to_sharding(
        {"w": logical}, {"w": _Leaf(shape)}, SINGLE,
        rules=mesh_lib.TRAIN_RULES, fsdp_axes=fsdp)
    assert sh["w"].spec == want
    ref = jmesh.logical_to_sharding(
        {"w": logical}, {"w": _Leaf(shape)}, _jmesh(SINGLE),
        rules=jmesh.TRAIN_RULES, fsdp_axes=fsdp)
    assert sh["w"].spec == tuple(ref["w"].spec)


def test_decode_rules_cache_seq_takes_model():
    spec = mesh_lib.resolve_spec(
        ("layers", "cache_batch", "cache_seq", "kv_heads", None),
        (22, 128, 32768, 4, 64), SINGLE, mesh_lib.DECODE_RULES)
    assert spec[2] == "model"
    assert spec[1] == "data"


def test_long_context_rules_shard_seq_over_data():
    spec = mesh_lib.resolve_spec(
        ("layers", "cache_batch", "cache_seq", "kv_heads", None),
        (22, 1, 524288, 4, 64), SINGLE, mesh_lib.LONG_CONTEXT_RULES)
    assert spec[2] == "data"
    assert spec[1] is None


def test_rule_tables_are_the_reference_s():
    from repro.launch import variants as jvariants
    assert mesh_lib.TRAIN_RULES == jmesh.TRAIN_RULES
    assert mesh_lib.DECODE_RULES == jmesh.DECODE_RULES
    assert mesh_lib.LONG_CONTEXT_RULES == jmesh.LONG_CONTEXT_RULES
    assert variants.DECODE_TP2D_RULES == jvariants.DECODE_TP2D_RULES
    assert variants.ZERO3_RULES == jvariants.ZERO3_RULES
    for m in (SINGLE, MULTI):
        for lc in (False, True):
            assert mesh_lib.batch_spec(m, long_context=lc) == tuple(
                jmesh.batch_spec(_jmesh(m), long_context=lc))


TABLES = [mesh_lib.TRAIN_RULES, mesh_lib.DECODE_RULES,
          mesh_lib.LONG_CONTEXT_RULES, variants.DECODE_TP2D_RULES,
          variants.ZERO3_RULES]


@given(st.lists(st.sampled_from(
    ["batch", "embed", "mlp", "heads", "kv_heads", "vocab", "seq", "expert",
     "cache_batch", "cache_seq", "layers", None]), min_size=1, max_size=5),
    st.lists(st.sampled_from([1, 2, 8, 16, 32, 64, 256, 1024, 4096]),
             min_size=5, max_size=5),
    st.booleans(), st.integers(0, len(TABLES) - 1),
    st.sampled_from([(), ("data",), ("pod", "data"),
                     ("pod", "data", "model")]))
@settings(max_examples=200, deadline=None)
def test_resolve_spec_equals_reference(logical, dims, multi, table, fsdp):
    """For ANY logical/shape combination the port's spec is the
    reference's (with and without the FSDP augmentation), and the
    reference's properties hold: no mesh axis twice, every split dim
    divisible, the arity kept."""
    mesh = MULTI if multi else SINGLE
    shape = tuple(dims[:len(logical)])
    rules = TABLES[table]
    spec = mesh_lib.resolve_spec(tuple(logical), shape, mesh, rules)
    assert spec == tuple(jmesh.resolve_spec(tuple(logical), shape,
                                            _jmesh(mesh), rules))
    aug = mesh_lib._fsdp_augment(spec, shape, mesh, fsdp)
    assert aug == tuple(jmesh._fsdp_augment(
        jmesh.P(*spec), shape, _jmesh(mesh), fsdp))
    assert len(spec) == len(shape)
    used = _axes_used(aug)
    assert len(used) == len(set(used))
    for dim, s in zip(shape, aug):
        if s is None:
            continue
        axes = (s,) if isinstance(s, str) else s
        assert dim % int(np.prod([mesh.shape[a] for a in axes])) == 0


def test_block_index_is_the_spec_order():
    """A dim split over ("model", "data") is model-major, as a JAX mesh
    lays it out; over ("pod", "data") pod-major."""
    m = mesh_lib.AbstractMesh((2, 4), ("data", "model"))
    assert block_index((("model", "data"),), {"data": 1, "model": 3}, m) \
        == (3 * 2 + 1,)
    assert block_index((("data", "model"),), {"data": 1, "model": 3}, m) \
        == (1 * 4 + 3,)
    assert mesh_lib.shard_shape((("model", "data"), None), (16, 5), m) \
        == (2, 5)


def test_production_mesh_factory():
    """make_production_mesh builds the brief's meshes on the fake group of
    256 and 512 ranks (a subprocess: the group must not outlive it)."""
    code = (
        "from repro_torch.launch import dryrun, mesh\n"
        "dryrun.init_fake_group(256)\n"
        "m1 = mesh.make_production_mesh(device_type='cpu')\n"
        "assert m1.mesh_dim_names == ('data', 'model'), m1\n"
        "assert tuple(m1.shape) == (16, 16), m1.shape\n"
        "dryrun.init_fake_group(512)\n"
        "m2 = mesh.make_production_mesh(multi_pod=True, device_type='cpu')\n"
        "assert tuple(m2.shape) == (2, 16, 16)\n"
        "assert m2.mesh_dim_names == ('pod', 'data', 'model')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok" in out.stdout
