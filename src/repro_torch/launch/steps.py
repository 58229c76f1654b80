"""Step builders — the single-device port of the prefill and serve steps
of ``repro/launch/steps.py``.

:func:`init_params` is the entry point that places a model: it resolves
the device (``"cuda"`` unless the caller asks for the CPU; without a card
it raises) and draws the parameters there from a seeded generator. Each
step builder returns a plain callable that runs under
``torch.inference_mode()`` on whatever device the parameters are on.
There are no meshes, shardings, AOT lowering or donation (ROADMAP queue 1
item 12); the serve step updates the caches in place, which is what the
reference's donation buys. ``make_train_step`` waits for the training
slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import api, lm as lm_mod


def model_cfg(spec):
    if spec.kind != "lm":
        raise NotImplementedError(
            f"kind={spec.kind!r} steps are not ported yet (ROADMAP queue 1 "
            f"item 12)")
    return spec.cfg


def init_params(spec, *, seed: int = 0, device="cuda"):
    """The model's parameters on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    device = dispatch.resolve_device(device)
    return api.init(torch.Generator(device=device).manual_seed(seed), spec)


def make_prefill_step(spec):
    """Forward over the full prompt; returns the last-position logits
    (B, 1, V) fp32, the sampling input. As in the reference, the prefill
    does not fill the decode cache."""
    cfg = model_cfg(spec)

    @torch.inference_mode()
    def prefill_step(params, batch):
        x, _ = lm_mod.forward(params, batch["tokens"], cfg)
        return lm_mod.logits_fn(params, x[:, -1:, :], cfg)

    return prefill_step


def make_serve_step(spec):
    """One-token decode against the caches: ``serve_step(params, token
    (B, 1), caches, index) -> (logits (B, 1, V) fp32, caches)``."""
    model_cfg(spec)

    @torch.inference_mode()
    def serve_step(params, token, caches, index: int):
        return api.decode_step(params, token, caches, index, spec)

    return serve_step
