"""Step builders — the single-device port of the prefill and serve steps
of ``repro/launch/steps.py``, for the three backbone kinds (lm, encdec,
vlm).

:func:`init_params` is the entry point that places a model: it resolves
the device (``"cuda"`` unless the caller asks for the CPU; without a card
it raises) and draws the parameters there from a seeded generator. Each
step builder returns a plain callable that runs under
``torch.inference_mode()`` on whatever device the parameters are on.
There are no meshes, shardings, AOT lowering or donation (the LM mesh,
ROADMAP queue 1 item 12d); the serve step updates the caches in place,
which is what the reference's donation buys. ``make_train_step`` waits
for LM training (item 12b).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import api, encdec as encdec_mod, lm as lm_mod


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
