"""Step builders — the single-device port of the train, prefill and serve
steps of ``repro/launch/steps.py``, for the three backbone kinds (lm,
encdec, vlm).

:func:`init_params` is the entry point that places a model: it resolves
the device (``"cuda"`` unless the caller asks for the CPU; without a card
it raises) and draws the parameters there from a seeded generator. Each
step builder returns a plain callable that runs on whatever device the
parameters are on: the prefill and serve steps under
``torch.inference_mode()``, the train step under autograd. There are no
meshes, shardings, AOT lowering or donation (the LM mesh, ROADMAP queue 1
item 12d); the serve step updates the caches in place, which is what the
reference's donation buys.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import api, encdec as encdec_mod, lm as lm_mod
from repro_torch.optim import adamw, clip as clip_mod, schedule
from repro_torch.tree import leaves, tree_map, unflatten_like


def model_cfg(spec):
    return spec.cfg.decoder if spec.kind == "encdec" else spec.cfg


def init_params(spec, *, seed: int = 0, device="cuda"):
    """The model's parameters on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    device = dispatch.resolve_device(device)
    return api.init(torch.Generator(device=device).manual_seed(seed), spec)


def make_prefill_step(spec):
    """Forward over the full prompt (``batch["tokens"]``, and
    ``batch["frames"]`` for encdec or ``batch["patches"]`` for vlm);
    returns the last-position logits (B, 1, V) fp32, the sampling input.
    As in the reference, the prefill does not fill the decode cache."""
    cfg = model_cfg(spec)

    @torch.inference_mode()
    def prefill_step(params, batch):
        if spec.kind == "encdec":
            enc = encdec_mod.encode(params, batch["frames"], spec.cfg)
            params = params["decoder"]
            x, _ = lm_mod.forward(params, batch["tokens"], cfg, cross_kv=enc)
        elif spec.kind == "vlm":
            x, _ = lm_mod.forward(params, batch["tokens"], cfg,
                                  cross_kv=batch["patches"])
        else:
            x, _ = lm_mod.forward(params, batch["tokens"], cfg)
        return lm_mod.logits_fn(params, x[:, -1:, :], cfg)

    return prefill_step


def make_serve_step(spec):
    """One-token decode against the caches: ``serve_step(params, token
    (B, 1), caches, index) -> (logits (B, 1, V) fp32, caches)``."""

    @torch.inference_mode()
    def serve_step(params, token, caches, index: int):
        return api.decode_step(params, token, caches, index, spec)

    return serve_step


def make_value_and_grad(loss_fn):
    """``value_and_grad(params, batch) -> ((loss, metrics), grads)``, the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``: gradients
    of every parameter leaf in its own dtype (zeros for a leaf the loss
    does not read), loss and metrics detached."""

    def value_and_grad(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
            unflatten_like(params, grads)

    return value_and_grad


def make_train_step(spec, shape=None, *, peak_lr: float = 3e-4,
                    grad_clip: float = 1.0, microbatches: int = 1):
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
    ``microbatches``; each call checks its own batch."""
    value_and_grad = make_value_and_grad(api.loss_fn(spec))
    lr_fn = schedule.warmup_cosine(peak_lr, 2_000, 100_000)
    adamw_cfg = adamw.AdamWConfig()
    if shape is not None:
        assert shape.global_batch % microbatches == 0, \
            (shape.global_batch, microbatches)

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        assert b % microbatches == 0, (b, microbatches)
        size = b // microbatches
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss_acc, m_acc = None, None
        for i in range(microbatches):
            mb = tree_map(lambda x: x[i * size:(i + 1) * size], batch)
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
        return params, opt, {**metrics, "loss": loss, "grad_norm": gnorm}

    return train_step
