"""The shardings of every architecture on the production meshes, exact:
the port's logical-spec trees equal the reference's, and the resolved
spec of every param, optimizer-state and decode-cache leaf equals the
reference's ``logical_to_sharding`` for every rule table with every
variant's ``fsdp_axes``, on SINGLE (data=16, model=16) and MULTI (pod=2,
data=16, model=16). The reference's shapes come from ``jax.eval_shape``,
the port's from its meta-device init (``launch.steps.param_sds``)."""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import registry as jregistry, shapes as jshapes
from repro.distributed import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import api as japi, lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.configs import registry, shapes
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import steps, variants
from repro_torch.models import api, lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves

MESHES = {"single": mesh_lib.AbstractMesh((16, 16), ("data", "model")),
          "multi": mesh_lib.AbstractMesh((2, 16, 16),
                                         ("pod", "data", "model"))}
TABLES = {"train": mesh_lib.TRAIN_RULES, "decode": mesh_lib.DECODE_RULES,
          "long": mesh_lib.LONG_CONTEXT_RULES,
          "decode_tp2d": variants.DECODE_TP2D_RULES,
          "zero3": variants.ZERO3_RULES}
# the fsdp_axes of the step builders' defaults and of every variant
FSDP = sorted({("pod", "data"), ()} | {
    fn(None, None).get("fsdp_axes", ("pod", "data"))
    for name, fn in variants.VARIANTS.items() if not name.startswith("moe")
    and name not in ("remat_dots", "train_zero3_dots")})


def _jmesh(m):
    try:
        return JAbstractMesh(m.sizes, m.names)
    except TypeError:
        return JAbstractMesh(tuple(zip(m.names, m.sizes)))


@functools.lru_cache(maxsize=None)
def _ref_sds(arch):
    spec = jregistry.get(arch)
    return jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), spec))


@functools.lru_cache(maxsize=None)
def _ref_cache_sds(arch):
    return jsteps.cache_sds(jregistry.get(arch),
                            jshapes.SHAPES["decode_32k"])


def _jspecs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _specs(tree):
    return [s.spec for s in leaves(tree) if s is not None]


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_logical_specs_equal_reference(arch):
    spec, jspec = registry.get(arch), jregistry.get(arch)
    assert api.logical_specs(spec) == japi.logical_specs(jspec)
    cfg = steps.model_cfg(spec)
    jcfg = jspec.cfg.decoder if jspec.kind == "encdec" else jspec.cfg
    assert lm.cache_logical_specs(cfg) == jlm.cache_logical_specs(jcfg)
    assert adamw.state_logical_specs(api.logical_specs(spec)) == \
        jadamw.state_logical_specs(japi.logical_specs(jspec))
    # the meta-device params and caches have the reference's shapes
    assert [tuple(x.shape) for x in leaves(steps.param_sds(spec))] == \
        [tuple(x.shape) for x in jax.tree.leaves(_ref_sds(arch))]
    if spec.has_decode:
        c = steps.cache_sds(spec, shapes.SHAPES["decode_32k"])
        assert [tuple(x.shape) for x in leaves(c) if x is not None] == \
            [tuple(x.shape) for x in jax.tree.leaves(_ref_cache_sds(arch))]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_resolved_specs_equal_reference(arch, mesh_kind):
    """Every param, optimizer and cache leaf's spec under every rule table
    and fsdp_axes."""
    mesh = MESHES[mesh_kind]
    jm = _jmesh(mesh)
    spec, jspec = registry.get(arch), jregistry.get(arch)
    p_sds, jp_sds = steps.param_sds(spec), _ref_sds(arch)
    for tname, rules in TABLES.items():
        for fsdp in FSDP:
            got = mesh_lib.logical_to_sharding(
                api.logical_specs(spec), p_sds, mesh, rules=rules,
                fsdp_axes=fsdp)
            want = jmesh.logical_to_sharding(
                japi.logical_specs(jspec), jp_sds, jm, rules=rules,
                fsdp_axes=fsdp)
            assert _specs(got) == _jspecs(want), (tname, fsdp)
            o_sh, _ = steps.opt_shardings(spec, mesh, got, p_sds)
            jo_sh, _ = jsteps.opt_shardings(jspec, jm, want, jp_sds)
            assert _specs(o_sh) == _jspecs(jo_sh), (tname, fsdp)
        if spec.has_decode:
            c_sh = steps.cache_shardings(
                spec, mesh, steps.cache_sds(spec, shapes.SHAPES[
                    "decode_32k"]), rules=rules)
            jc_sh = jsteps.cache_shardings(jspec, jm, _ref_cache_sds(arch),
                                           rules=rules)
            assert _specs(c_sh) == _jspecs(jc_sh), tname
