"""The LM mesh against the reference on the same inputs: the host mesh's
(data=1, model=1) train, prefill and serve steps against the JAX
``models/api.py`` (``loss_fn``'s value, the last-position logits of
``lm.forward``, ``decode_step``'s logits) for tinyllama and granite-moe at
reduced size in float32, within 1e-5 relative; ``_attend_decode_sharded``
against the reference's with an identity constraint; ``outer_step(
pod_axis="pod")`` on two gloo pods against the reference's under
``jax.vmap(..., axis_name="pod")``, fp32 and int8, within 1e-6; and every
``launch.variants.VARIANTS`` entry running one step on the host mesh
(granite-moe for the ``moe_*`` entries), as ``tests/test_steps_variants.py``
does for the reference. The host mesh's one-rank group is ended by each
test; the pods are two spawned ranks."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

import jax
import jax.numpy as jnp

from _torch_parity import train_batch, train_params, train_specs
from repro.models import api as japi, lm as jlm
from repro.nn import attention as jattn
from repro.optim import outer as jouter
from repro_torch.configs import registry, shapes
from repro_torch.distributed import bootstrap
from repro_torch.launch import mesh as launch_mesh, steps, variants
from repro_torch.nn import attention as tattn
from repro_torch.optim import adamw

import _torch_mesh_jobs as jobs

TOL = 1e-5


@pytest.fixture
def host_mesh():
    mesh = launch_mesh.make_host_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        bootstrap.release_solo_group()


def rel(got, want) -> float:
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_host_mesh_steps_match_reference(arch, host_mesh):
    js, ts = train_specs(arch)
    jp, tp = train_params(arch)
    jb, tb = train_batch(js, 2, 16)
    tb = {k: torch.as_tensor(v) for k, v in tb.items()}
    # train: the step's loss is loss_fn's value at the params it starts from
    shape = shapes.Shape("train_4k", 16, 2, "train")
    bundle = steps.make_train_step(ts, shape, host_mesh)
    _, _, m = bundle.fn(*bundle.place(tp, adamw.init(tp, per_agent=False),
                                      tb))
    jl, jm = jax.jit(japi.loss_fn(js))(jp, jb)
    assert rel(m["loss"], jl) <= TOL and rel(m["xent"], jm["xent"]) <= TOL
    # prefill: the last position's logits
    shape = shapes.Shape("prefill_32k", 16, 2, "prefill")
    bundle = steps.make_prefill_step(ts, shape, host_mesh)
    got = bundle.fn(*bundle.place(tp, {"tokens": tb["tokens"]}))
    x, _ = jlm.forward(jp, jnp.asarray(jb["tokens"]), js.cfg)
    assert rel(got, jlm.logits_fn(jp, x[:, -1:], js.cfg)) <= TOL
    # serve: three decode steps against a 16-slot cache
    shape = shapes.Shape("decode_32k", 16, 2, "decode")
    bundle = steps.make_serve_step(ts, shape, host_mesh)
    p, _, c, _ = bundle.place(tp, None,
                              steps.build_caches(tp, ts, shape), 0)
    jc = japi.init_caches(jp, js, 2, 16)
    for i in range(3):
        tok = jb["tokens"][:, i:i + 1]
        lg, c = bundle.fn(p, bundle.place(None, torch.as_tensor(tok), None,
                                          0)[1], c, i)
        jl, jc = japi.decode_step(jp, jnp.asarray(tok), jc, i, js)
        assert rel(lg, jl) <= TOL, i


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0)])
def test_attend_decode_sharded_matches_reference(window, softcap):
    """The distributed softmax's math, plain tensors and an identity
    constraint on both sides (its split form runs in
    tests/test_torch_mesh_numerics.py)."""
    rng = np.random.default_rng(3)
    b, s, h, hkv, dh = 2, 12, 4, 2, 8
    q = rng.standard_normal((b, 1, h, dh), np.float32)
    k = rng.standard_normal((b, s, hkv, dh), np.float32)
    v = rng.standard_normal((b, s, hkv, dh), np.float32)
    pos = np.array([0, 1, 2, 3, 4, 5, 6, 7, -1, -1, -1, -1], np.int32)
    jcfg = jattn.AttentionConfig(d_model=h * dh, num_heads=h,
                                 num_kv_heads=hkv, sliding_window=window,
                                 attn_softcap=softcap, dtype=jnp.float32)
    tcfg = tattn.AttentionConfig(d_model=h * dh, num_heads=h,
                                 num_kv_heads=hkv, sliding_window=window,
                                 attn_softcap=softcap, dtype=torch.float32)
    want = jattn._attend_decode_sharded(q, k, v, jcfg, 7, jnp.asarray(pos),
                                        lambda t: t)
    got = tattn._attend_decode_sharded(
        *(torch.tensor(a) for a in (q, k, v)), tcfg, 7, torch.tensor(pos),
        lambda t: t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_outer_step_on_two_pods_matches_reference(int8):
    rng = np.random.default_rng(7)
    anchor = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    pods = [{k: (v - 0.01 * (p + 1) * rng.standard_normal(v.shape))
             .astype(np.float32) for k, v in anchor.items()}
            for p in range(2)]
    cfg = jouter.OuterConfig(compress_int8=int8)
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    state = jouter.init(jax.tree.map(jnp.asarray, anchor))
    want_p, want_s, _ = jax.vmap(
        lambda lp, st: jouter.outer_step(lp, st, cfg, pod_axis="pod"),
        axis_name="pod")(stack(pods), stack([state, state]))
    ranks = bootstrap.spawn_local(2, jobs.outer_pods, anchor, pods, int8,
                                  timeout_s=120)
    want = jax.tree.leaves((want_p, want_s))
    for p, out in enumerate(ranks):
        got = jax.tree.leaves((out["params"], out["state"]))
        assert len(got) == len(want)
        for g, w in zip(got, (np.asarray(x)[p] for x in want)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", sorted(variants.VARIANTS))
def test_every_variant_runs_on_host_mesh(variant, host_mesh):
    arch = ("granite-moe-1b-a400m" if variant.startswith("moe")
            else "tinyllama-1.1b")
    kind = "decode" if variant.startswith("decode") else "train"
    spec = registry.get(arch, reduced=True)
    # one layer: the variant's layouts, not the depth, are under test
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg,
                                                             n_layers=1))
    shape = shapes.Shape(kind, 16, 16, kind)
    kw = variants.VARIANTS[variant](spec, shape)
    spec = kw.pop("spec", spec)
    params = steps.init_params(spec, seed=0, device="cpu")
    bundle = steps.make_step(spec, shape, host_mesh, **kw)
    if kind == "decode":
        p, tok, c, _ = bundle.place(
            params, torch.zeros((16, 1), dtype=torch.int32),
            steps.build_caches(params, spec, shape), 0)
        logits, _ = bundle.fn(p, tok, c, 0)
        assert bool(torch.isfinite(logits.full_tensor()).all())
    else:
        from repro_torch import random as R
        batch = registry.concrete_inputs(R.key(0, device="cpu"), spec,
                                         shape)
        _, opt2, m = bundle.fn(*bundle.place(
            params, adamw.init(params, per_agent=False), batch))
        assert np.isfinite(float(m["loss"]))
        assert int(opt2["step"].full_tensor()) == 1
