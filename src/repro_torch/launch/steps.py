"""Step builders — the port of ``repro/launch/steps.py``: train_step /
prefill_step / serve_step for the three backbone kinds (lm, encdec, vlm),
on one device or on a mesh.

:func:`init_params` is the entry point that places a model: it resolves
the device (``"cuda"`` unless the caller asks for the CPU; without a card
it raises) and draws the parameters there from a seeded generator.

Without a mesh each builder returns a plain callable that runs on
whatever device the parameters are on: the prefill and serve steps under
``torch.inference_mode()``, the train step under autograd. The serve step
updates the caches in place, which is what the reference's donation buys.

With a mesh (a named ``DeviceMesh``: ``launch.mesh``) a builder returns a
:class:`StepBundle`: the step over DTensor arguments, the arguments' specs
(meta tensors: shapes and dtypes, no allocation — the reference's
ShapeDtypeStructs), their shardings resolved from the logical-axis rules
(``repro_torch.distributed.mesh``) and the kind. ``bundle.place(*args)``
lays full tensors out by those shardings. There is no AOT lowering: the
step runs eagerly, each op dispatched by DTensor on the local blocks, and
the dry-run (``launch.dryrun``) runs it once on fake tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs import registry, shapes as shapes_mod
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.kernels import dispatch
from repro_torch.models import api, encdec as encdec_mod, lm as lm_mod
from repro_torch.models import vlm as vlm_mod
from repro_torch.nn.init import SHAPES_ONLY
from repro_torch.optim import adamw, clip as clip_mod, schedule
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A mesh step, the specs of its arguments (trees of meta tensors),
    their shardings (parallel trees of ``mesh.NamedSharding``) and its
    kind (train | prefill | decode)."""
    fn: Callable
    arg_specs: tuple
    shardings: tuple
    kind: str

    def place(self, *args):
        """Full tensors (the same on every rank, on the mesh's device) laid
        out as DTensors by the bundle's shardings; a Python int (the
        decode index) passes through."""
        return tuple(_place(a, spec, sh) for a, spec, sh
                     in zip(args, self.arg_specs, self.shardings))


def _place(tree, spec_tree, sh_tree):
    def one(x, spec, sh):
        if not isinstance(x, torch.Tensor):
            return x
        if mesh_lib.is_dtensor(x):
            return mesh_lib.constrain(x, sh)
        return mesh_lib.distribute(x.to(spec.dtype), sh)
    return tree_map(one, tree, spec_tree, sh_tree)


def model_cfg(spec):
    return spec.cfg.decoder if spec.kind == "encdec" else spec.cfg


def init_params(spec, *, seed: int = 0, device="cuda"):
    """The model's parameters on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    device = dispatch.resolve_device(device)
    return api.init(torch.Generator(device=device).manual_seed(seed), spec)


def _no_grad(mesh):
    """``inference_mode`` on one device; ``no_grad`` on the mesh (DTensor
    views of inference tensors are refused)."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _batch_shardings(batch_specs, mesh, *, long_context=False):
    spec = mesh_lib.batch_spec(mesh, long_context=long_context)

    def one(x):
        if x.ndim == 0:
            return mesh_lib.replicated(mesh)
        return mesh_lib.NamedSharding(
            mesh, tuple(spec) + (None,) * (x.ndim - len(spec)))
    return tree_map(one, batch_specs)


def act_constraint_for(mesh, *, seq_axis: str = "model"):
    """Sequence-parallel residual-stream constraint: the carry between
    repeats is stored (batch -> data, seq -> model)-split, cutting the
    activation memory kept across the depth by the TP degree."""
    shape = mesh_lib.mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    sh = mesh_lib.NamedSharding(mesh, (
        batch_axes if len(batch_axes) > 1 else batch_axes[0],
        seq_axis if seq_axis in shape else None, None))
    return lambda x: mesh_lib.constrain(x, sh)


# ---------------------------------------------------------------------------
# Shardings for params / optimizer / caches
# ---------------------------------------------------------------------------
def param_sds(spec) -> dict:
    """The params' shapes and dtypes as meta tensors (no allocation)."""
    return api.init(SHAPES_ONLY, spec)


def param_shardings(spec, mesh, *, rules=mesh_lib.TRAIN_RULES,
                    fsdp_axes=("pod", "data")):
    sds = param_sds(spec)
    return mesh_lib.logical_to_sharding(
        api.logical_specs(spec), sds, mesh, rules=rules,
        fsdp_axes=fsdp_axes), sds


def opt_shardings(spec, mesh, p_shardings, p_sds):
    o_sds = adamw.init(p_sds, per_agent=False)
    sh = {"mu": p_shardings, "nu": p_shardings, "master": p_shardings,
          "step": mesh_lib.replicated(mesh)}
    return sh, o_sds


def _cache_inputs(spec, shape: shapes_mod.Shape, device):
    """The stub frontend's zero source of the cross caches (encdec
    frames, vlm patches), or None."""
    b = shape.global_batch
    if spec.kind == "encdec":
        return torch.zeros((b, spec.n_frames, spec.cfg.d_model),
                           dtype=torch.bfloat16, device=device)
    if spec.kind == "vlm":
        return torch.zeros((b, spec.n_patches, spec.vision_dim),
                           dtype=torch.bfloat16, device=device)
    return None


def build_caches(params, spec, shape: shapes_mod.Shape, device=None):
    """The decode caches of a shape cell for ``params`` (cross caches from
    the stub frontend's zero frames or patches)."""
    device = device or leaves(params)[0].device
    b, src = shape.global_batch, _cache_inputs(spec, shape, device)
    if spec.kind == "encdec":
        return encdec_mod.init_decode_caches(params, spec.cfg, src, b,
                                             shape.seq_len)
    if spec.kind == "vlm":
        return vlm_mod.init_decode_caches(params, spec.cfg, src, b,
                                          shape.seq_len)
    return lm_mod.init_caches(params, spec.cfg, b, shape.seq_len)


def cache_sds(spec, shape: shapes_mod.Shape):
    """Meta tensors of the decode caches for a shape cell."""
    return build_caches(param_sds(spec), spec, shape, torch.device("meta"))


def cache_shardings(spec, mesh, c_sds, *, rules):
    logical = lm_mod.cache_logical_specs(model_cfg(spec))
    return mesh_lib.logical_to_sharding(logical, c_sds, mesh, rules=rules)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def make_prefill_step(spec, shape: Optional[shapes_mod.Shape] = None,
                      mesh=None, *, rules=mesh_lib.TRAIN_RULES,
                      fsdp_axes=("pod", "data"), seq_parallel: bool = True):
    """Forward over the full prompt (``batch["tokens"]``, and
    ``batch["frames"]`` for encdec or ``batch["patches"]`` for vlm);
    returns the last-position logits (B, 1, V) fp32, the sampling input.
    As in the reference, the prefill does not fill the decode cache.
    With a mesh, a :class:`StepBundle` for the ``shape`` cell."""
    cfg = model_cfg(spec)
    act = act_constraint_for(mesh) if mesh is not None and seq_parallel \
        else None

    @_no_grad(mesh)
    def prefill_step(params, batch):
        if spec.kind == "encdec":
            enc = encdec_mod.encode(params, batch["frames"], spec.cfg)
            params = params["decoder"]
            x, _ = lm_mod.forward(params, batch["tokens"], cfg, cross_kv=enc,
                                  act_constraint=act)
        elif spec.kind == "vlm":
            x, _ = lm_mod.forward(params, batch["tokens"], cfg,
                                  cross_kv=batch["patches"],
                                  act_constraint=act)
        else:
            x, _ = lm_mod.forward(params, batch["tokens"], cfg,
                                  act_constraint=act)
        return lm_mod.logits_fn(params, x[:, -1:, :], cfg)

    if mesh is None:
        return prefill_step
    p_sh, p_sds = param_shardings(spec, mesh, rules=rules,
                                  fsdp_axes=fsdp_axes)
    b_sds = registry.input_specs(spec, shape)
    return StepBundle(fn=prefill_step, arg_specs=(p_sds, b_sds),
                      shardings=(p_sh, _batch_shardings(b_sds, mesh)),
                      kind="prefill")


def make_serve_step(spec, shape: Optional[shapes_mod.Shape] = None,
                    mesh=None, *, rules: Optional[tuple] = None,
                    fsdp_axes=(), sharded_softmax: bool = True):
    """One-token decode against the caches: ``serve_step(params, token
    (B, 1), caches, index) -> (logits (B, 1, V) fp32, caches)``, the
    caches updated in place. With a mesh, a :class:`StepBundle` for the
    ``shape`` cell (a seq_len cache); ``sharded_softmax`` runs the
    distributed softmax over the cache sequence axis where the rules
    split it (else each rank reads its rows' whole cache)."""
    if mesh is None:
        @torch.inference_mode()
        def serve_step(params, token, caches, index: int):
            return api.decode_step(params, token, caches, index, spec)
        return serve_step

    long_ctx = shape.name.startswith("long")
    if rules is None:
        rules = (mesh_lib.LONG_CONTEXT_RULES if long_ctx
                 else mesh_lib.DECODE_RULES)
    seq_axis = dict(rules).get("cache_seq")
    lconstraint = None
    if sharded_softmax and isinstance(seq_axis, str) \
            and seq_axis in mesh_lib.mesh_shape(mesh):
        batch_axes = mesh_lib.batch_spec(mesh, long_context=long_ctx)[0]
        lsh = mesh_lib.NamedSharding(mesh, (batch_axes, None, None,
                                            seq_axis))

        def lconstraint(t):
            return mesh_lib.constrain(t, lsh)

    @_no_grad(mesh)
    def serve_step(params, token, caches, index: int):
        return api.decode_step(params, token, caches, int(index), spec,
                               logits_constraint=lconstraint)

    p_sh, p_sds = param_shardings(spec, mesh, rules=rules,
                                  fsdp_axes=fsdp_axes)
    c_sds = cache_sds(spec, shape)
    c_sh = cache_shardings(spec, mesh, c_sds, rules=rules)
    specs = registry.input_specs(spec, shape)
    tok_sh = _batch_shardings(specs["token"], mesh, long_context=long_ctx)
    return StepBundle(
        fn=serve_step,
        arg_specs=(p_sds, specs["token"], c_sds, specs["index"]),
        shardings=(p_sh, tok_sh, c_sh, mesh_lib.replicated(mesh)),
        kind="decode")


def make_value_and_grad(loss_fn):
    """``value_and_grad(params, batch) -> ((loss, metrics), grads)``, the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``: gradients
    of every parameter leaf in its own dtype (zeros for a leaf the loss
    does not read), loss and metrics detached. A DTensor leaf's gradient
    is laid out as the leaf (partial sums reduced)."""

    def value_and_grad(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 g.redistribute(p.device_mesh, p.placements)
                 if mesh_lib.is_dtensor(p) else g
                 for p, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
            unflatten_like(params, grads)

    return value_and_grad


def make_train_step(spec, shape=None, mesh=None, *,
                    rules=mesh_lib.TRAIN_RULES, fsdp_axes=("pod", "data"),
                    peak_lr: float = 3e-4, grad_clip: float = 1.0,
                    seq_parallel: bool = True, batch_axes=None,
                    microbatches: int = 1):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``: the
    gradient of ``api.loss_fn`` over the parameter leaves (accumulated
    over ``microbatches`` slices of the batch axis in fp32, loss and
    metrics summed, all three scaled by 1/microbatches, as the
    reference's scan), then ``sanitize``, the global-norm clip, AdamW at
    ``warmup_cosine(peak_lr, 2000, 100000)(opt["step"])`` and the cast
    back to the params' dtypes. ``opt`` is ``adamw.init(params,
    per_agent=False)``; metrics hold {xent, load_balance, z_loss, loss,
    grad_norm}, 0-d tensors on the params' device. ``shape`` (a
    ``configs.shapes.Shape``) checks its global batch against
    ``microbatches``; each call checks its own batch.

    With a mesh it returns a :class:`StepBundle`: params and optimizer
    state laid out by ``rules`` with FSDP over ``fsdp_axes``, the batch
    over (pod, data) — or over ``batch_axes``, the pure data-parallel
    (ZeRO-3) layout, whose residual carry is constrained to the batch
    split — and with ``seq_parallel`` the residual carry sequence-split
    over ``model``. A microbatch is the same global rows as on one device
    (a slice of the batch, laid out again as the batch); the metrics come
    back as plain 0-d tensors."""
    act, b_sh = None, None
    if mesh is not None:
        b_sds = registry.input_specs(spec, shape)
        if batch_axes is not None:
            names = mesh_lib.mesh_shape(mesh)
            axes = tuple(a for a in batch_axes if a in names)
            bsh = mesh_lib.NamedSharding(mesh, (axes, None, None))
            act = lambda x: mesh_lib.constrain(x, bsh)  # noqa: E731
            b_sh = tree_map(lambda x: mesh_lib.NamedSharding(
                mesh, (axes,) + (None,) * (x.ndim - 1)), b_sds)
        else:
            act = act_constraint_for(mesh) if seq_parallel else None
            b_sh = _batch_shardings(b_sds, mesh)
    value_and_grad = make_value_and_grad(api.loss_fn(spec,
                                                     act_constraint=act))
    lr_fn = schedule.warmup_cosine(peak_lr, 2_000, 100_000)
    adamw_cfg = adamw.AdamWConfig()
    if shape is not None:
        assert shape.global_batch % microbatches == 0, \
            (shape.global_batch, microbatches)

    def microbatch(batch, i, size):
        if b_sh is None:
            return tree_map(lambda x: x[i * size:(i + 1) * size], batch)
        return tree_map(lambda x, sh: mesh_lib.constrain(
            x[i * size:(i + 1) * size], sh), batch, b_sh)

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        assert b % microbatches == 0, (b, microbatches)
        size = b // microbatches
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        loss_acc, m_acc = None, None
        for i in range(microbatches):
            mb = microbatch(batch, i, size)
            (loss, metrics), grads = value_and_grad(params, mb)
            for acc, g in zip(leaves(g_acc), leaves(grads)):
                acc.add_(g)
            del grads
            if loss_acc is None:
                loss_acc, m_acc = loss.float(), metrics
            else:
                loss_acc = loss_acc + loss
                m_acc = {k: m_acc[k] + v for k, v in metrics.items()}
        scale = 1.0 / microbatches
        for acc in leaves(g_acc):
            acc.mul_(scale)
        return (loss_acc * scale, {k: v * scale for k, v in m_acc.items()}), \
            g_acc

    def train_step(params, opt, batch):
        (loss, metrics), grads = grads_of(params, batch)
        grads = clip_mod.sanitize(grads)
        grads, gnorm = clip_mod.clip_by_global_norm(grads, grad_clip,
                                                    per_agent=False)
        master, opt = adamw.update(grads, opt, lr_fn(opt["step"]), adamw_cfg)
        params = adamw.cast_like(master, params)
        out = {**metrics, "loss": loss, "grad_norm": gnorm}
        if mesh is not None:
            out = {k: v.full_tensor() if mesh_lib.is_dtensor(v) else v
                   for k, v in out.items()}
        return params, opt, out

    if mesh is None:
        return train_step
    p_sh, p_sds = param_shardings(spec, mesh, rules=rules,
                                  fsdp_axes=fsdp_axes)
    o_sh, o_sds = opt_shardings(spec, mesh, p_sh, p_sds)
    return StepBundle(fn=train_step, arg_specs=(p_sds, o_sds, b_sds),
                      shardings=(p_sh, o_sh, b_sh), kind="train")


def make_step(spec, shape: shapes_mod.Shape, mesh, **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(spec, shape, mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(spec, shape, mesh, **kw)
    return make_serve_step(spec, shape, mesh, **kw)
