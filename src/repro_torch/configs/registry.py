"""Architecture registry — the port of ``repro/configs/registry.py``:
``get(arch_id, reduced=...)`` -> ArchSpec, over all ten architectures of
the reference, plus ``input_specs`` (meta-tensor stand-ins for every model
input of a shape cell: shapes and dtypes, no allocation), the concrete
batches of the smoke paths and the cells the dry-run skips.
"""
from __future__ import annotations

import torch

from repro_torch.configs import shapes as shapes_mod
from repro_torch.configs import (dbrx_132b, gemma2_9b, granite_moe_1b,
                                 llama32_vision_90b, mamba2_780m,
                                 qwen1_5_32b, tinyllama_1_1b, whisper_tiny,
                                 yi_34b, zamba2_1_2b)

ARCHS = {
    "yi-34b": yi_34b.make,
    "gemma2-9b": gemma2_9b.make,
    "tinyllama-1.1b": tinyllama_1_1b.make,
    "qwen1.5-32b": qwen1_5_32b.make,
    "zamba2-1.2b": zamba2_1_2b.make,
    "granite-moe-1b-a400m": granite_moe_1b.make,
    "dbrx-132b": dbrx_132b.make,
    "whisper-tiny": whisper_tiny.make,
    "llama-3.2-vision-90b": llama32_vision_90b.make,
    "mamba2-780m": mamba2_780m.make,
}


def get(arch_id: str, *, reduced: bool = False):
    return ARCHS[arch_id](reduced=reduced)


def list_archs():
    return sorted(ARCHS)


def _vocab(spec):
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    return cfg.vocab


def cell_supported(spec, shape: shapes_mod.Shape) -> tuple:
    """(supported, reason) — the brief's skip rules."""
    if shape.name == "long_500k" and not spec.sub_quadratic:
        return False, "full quadratic attention at 524k context"
    return True, ""


def input_specs(spec, shape: shapes_mod.Shape, device="meta"):
    """Stand-ins for every model input of the shape cell, as the
    reference's ShapeDtypeStructs: tensors on ``device`` (meta: no
    allocation) with the reference's shapes and dtypes (int32 tokens).
    For decode kinds this is the (token, index) pair — caches are built
    separately."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=device)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    if shape.kind == "train":
        batch = {"tokens": torch.empty((b, s), **i32),
                 "labels": torch.empty((b, s), **i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": torch.empty((b, s), **i32)}
    else:  # decode: one new token against a seq_len cache
        batch = {"token": torch.empty((b, 1), **i32),
                 "index": torch.empty((), **i32)}
    if spec.kind == "encdec" and shape.kind != "decode":
        batch["frames"] = torch.empty((b, spec.n_frames, spec.cfg.d_model),
                                      **bf16)
    if spec.kind == "vlm" and shape.kind != "decode":
        batch["patches"] = torch.empty((b, spec.n_patches, spec.vision_dim),
                                       **bf16)
    return batch


def concrete_inputs(key, spec, shape: shapes_mod.Shape):
    """Small concrete batches for smoke paths (reduced shapes), on the
    device of ``key`` (a ``repro_torch.random`` key), the reference's
    streams: tokens bit for bit, frames and patches through the port's
    normal draw."""
    from repro_torch.data import synthetic
    b, s = shape.global_batch, shape.seq_len
    vocab = _vocab(spec)
    dev = key.device
    if shape.kind == "train":
        batch = synthetic.lm_batch(key, b, s, vocab)
    elif shape.kind == "prefill":
        batch = {"tokens": synthetic.lm_batch(key, b, s, vocab)["tokens"]}
    else:
        batch = {"token": torch.zeros((b, 1), dtype=torch.int32, device=dev),
                 "index": torch.zeros((), dtype=torch.int32, device=dev)}
    if spec.kind == "encdec" and shape.kind != "decode":
        batch["frames"] = synthetic.frames(key, b, spec.n_frames,
                                           spec.cfg.d_model)
    if spec.kind == "vlm" and shape.kind != "decode":
        batch["patches"] = synthetic.patches(key, b, spec.n_patches,
                                             spec.vision_dim)
    return batch
