"""Helpers of the port's parity tests (``tests/test_torch_*.py``): move
pytrees between the JAX package and the port, and compare them.

The same inputs, made with numpy from a seed or by the reference itself,
go through a JAX function and its ``repro_torch`` counterpart; JAX runs on
the CPU with ``use_kernels="off"`` (its own tests hold its Pallas kernels
to that oracle).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import convert

# The suite runs several test processes side by side; at these small
# sizes one intra-op thread each is enough, and more would take cores
# from the timing-sensitive multi-process tests running beside them.
torch.set_num_threads(1)


def to_torch(tree):
    """A JAX (or numpy) pytree -> the port's tensors on the CPU."""
    return convert.from_jax_params(jax.device_get(tree), "cpu")


def to_np(tree):
    return convert.to_numpy(tree)


def np_leaves(tree):
    """Leaves as numpy, in jax.tree order, from either side."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = to_np(tree)
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]


def tree_maxdiff(a, b) -> float:
    la, lb = np_leaves(a), np_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape, (x.shape, y.shape)
    return max(float(np.abs(x.astype(np.float64) - y.astype(np.float64))
                     .max()) for x, y in zip(la, lb))


def assert_close_scaled(actual, desired, tol: float):
    """max |actual - desired| <= tol * max(1, max |desired|): an absolute
    tolerance on tensors of magnitude <= 1, relative to the largest
    magnitude above that (sums over many terms carry rounding in
    proportion to their size)."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    err = float(np.abs(actual - desired).max())
    scale = max(1.0, float(np.abs(desired).max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


def assert_tree_equal(a, b):
    for x, y in zip(np_leaves(a), np_leaves(b)):
        np.testing.assert_array_equal(x.astype(np.int64)
                                      if x.dtype == np.uint32 else x,
                                      y.astype(np.int64)
                                      if y.dtype == np.uint32 else y)


def jkey_to_torch(key):
    return torch.tensor(np.asarray(key).astype(np.int64))


def layer_dtype(ls, dt):
    """A LayerSpec with every config dtype set to ``dt``."""
    subs = {name: dataclasses.replace(getattr(ls, name), dtype=dt)
            for name in ("attn", "ssm", "mlp", "moe")
            if getattr(ls, name) is not None}
    return dataclasses.replace(ls, dtype=dt, **subs)


def replace_model_dtype(cfg, dt):
    """A ModelConfig with every config dtype set to ``dt``."""
    return dataclasses.replace(
        cfg, dtype=dt, period=tuple(layer_dtype(ls, dt)
                                    for ls in cfg.period),
        shared=cfg.shared and layer_dtype(cfg.shared, dt))


def plain(obj):
    """A config as nested plain values: dataclasses by class name and
    field, dtypes by name, on either side."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, torch.dtype):
        return str(obj).replace("torch.", "")
    if isinstance(obj, type) or "dtype" in type(obj).__name__.lower():
        return jnp.dtype(obj).name
    return obj


# ---------------------------------------------------------------------------
# LM training parity (tests/test_torch_{lm_train*,train_step,train_cli}.py)
# ---------------------------------------------------------------------------
TRAIN_GATE = 0.5


def spec_dtype(spec, dt, **kw):
    """An ArchSpec of either package with every config dtype set to ``dt``
    (None keeps them) and the model config's fields ``kw`` replaced (an
    enc-dec's decoder config)."""
    cfg = spec.cfg
    if spec.kind == "encdec":
        dec = cfg.decoder
        if dt is not None:
            cfg = dataclasses.replace(
                cfg, dtype=dt, encoder_period=tuple(
                    layer_dtype(ls, dt) for ls in cfg.encoder_period))
            dec = replace_model_dtype(dec, dt)
        return dataclasses.replace(spec, cfg=dataclasses.replace(
            cfg, decoder=dataclasses.replace(dec, **kw)))
    if dt is not None:
        cfg = replace_model_dtype(cfg, dt)
    return dataclasses.replace(spec, cfg=dataclasses.replace(cfg, **kw))


def train_specs(arch, dtype="float32", **kw):
    """(reference spec, port spec) of a reduced architecture; ``dtype``
    "float32" replaces every config dtype, "bfloat16" keeps the shipped
    ones."""
    from repro.configs import registry as jregistry
    from repro_torch.configs import registry as tregistry
    f32 = dtype == "float32"
    return (spec_dtype(jregistry.get(arch, reduced=True),
                       jnp.float32 if f32 else None, **kw),
            spec_dtype(tregistry.get(arch, reduced=True),
                       torch.float32 if f32 else None, **kw))


_TRAIN_PARAMS = {}


def train_params(arch, dtype="float32"):
    """The reference's ``api.init`` params of the reduced architecture
    (cached) and their port copy; llama-vision's tanh gates set to
    TRAIN_GATE, so the cross-attention path carries gradient."""
    if (arch, dtype) not in _TRAIN_PARAMS:
        from repro.models import api as japi
        js, _ = train_specs(arch, dtype)
        jp = jax.jit(lambda k: japi.init(k, js))(jax.random.PRNGKey(0))
        if js.kind == "vlm":
            jp["layers"] = [
                {**layer, **{n: jnp.full_like(layer[n], TRAIN_GATE)
                             for n in ("gate_attn", "gate_ffn")
                             if n in layer}}
                for layer in jp["layers"]]
        _TRAIN_PARAMS[arch, dtype] = (jp, to_torch(jp))
    return _TRAIN_PARAMS[arch, dtype]


def train_batch(spec, b: int, t: int, seed: int = 1, dtype=jnp.float32):
    """A reference batch from ``repro.data.synthetic`` (numpy) and its port
    copy: tokens and labels, and frames or patches for enc-dec or VLM."""
    from repro.data import synthetic as jsyn
    key = jax.random.PRNGKey(seed)
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    # one compile, not one an op (the same bits as op by op)
    batch = jax.jit(lambda k: jsyn.lm_batch(k, b, t, cfg.vocab))(key)
    if spec.kind == "encdec":
        batch["frames"] = jsyn.frames(jax.random.fold_in(key, 1), b,
                                      spec.n_frames, spec.cfg.d_model, dtype)
    if spec.kind == "vlm":
        batch["patches"] = jsyn.patches(jax.random.fold_in(key, 1), b,
                                        spec.n_patches, spec.vision_dim,
                                        dtype)
    batch = {k: np.asarray(v) for k, v in jax.device_get(batch).items()}
    return batch, to_torch(batch)


def assert_leaves_close(got, want, tol: float):
    """Leaf by leaf: max |got - want| <= tol * max |want| (each leaf held
    relative to its own largest magnitude; an all-zero leaf exactly)."""
    gl, wl = np_leaves(got), np_leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        g, w = g.astype(np.float64), w.astype(np.float64)
        err = float(np.abs(g - w).max()) if g.size else 0.0
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert err <= tol * scale, \
            f"leaf {i}: max abs err {err:.3e} > {tol} * {scale:.3g}"


TRAIN_F32_TOL = 1e-4      # loss, metrics, every gradient leaf (float32)
TRAIN_BF16_TOL = 2e-3     # the loss and metrics in bf16, relative


def check_loss_and_grads(arch, dtype, b=2, t=32):
    """The port's ``api.loss_fn`` under ``steps.make_value_and_grad``
    against ``jax.value_and_grad(api.loss_fn(spec))`` on the reference's
    weights and batch: float32 loss, metrics and every gradient leaf
    within TRAIN_F32_TOL of the leaf's largest magnitude; bfloat16 (the
    shipped configs) loss and xent within TRAIN_BF16_TOL relative, the
    MoE aux terms likewise, each gradient leaf finite."""
    from repro.models import api as japi
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import api as tapi
    js, ts = train_specs(arch, dtype)
    jp, tp = train_params(arch, dtype)
    jb, tb = train_batch(js, b, t, dtype=jnp.float32 if dtype == "float32"
                         else jnp.bfloat16)
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss_fn(js),
                                              has_aux=True))(jp, jb)
    (tl, tm), tg = tsteps.make_value_and_grad(tapi.loss_fn(ts))(tp, tb)
    assert sorted(tm) == sorted(jm) == ["load_balance", "xent", "z_loss"]
    assert tl.dtype == torch.float32 and tl.shape == ()
    for i, (a, g) in enumerate(zip(np_leaves(jg), np_leaves(tg))):
        assert a.shape == g.shape, (i, a.shape, g.shape)
    for p, g in zip(jax.tree.leaves(tp), jax.tree.leaves(tg)):
        assert g.dtype == p.dtype
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=TRAIN_F32_TOL)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=TRAIN_F32_TOL, atol=1e-6)
        assert_leaves_close(tg, jg, TRAIN_F32_TOL)
    else:
        for got, want in [(tl, jl)] + [(tm[k], jm[k]) for k in jm]:
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=TRAIN_BF16_TOL, atol=1e-6)
        assert all(np.isfinite(g).all() for g in np_leaves(tg))
    return float(tl)
