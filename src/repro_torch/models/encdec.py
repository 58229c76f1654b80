"""Encoder-decoder backbone (whisper-tiny) — the port of
``repro/models/encdec.py``.

The audio frontend is a stub, as in the reference: the caller feeds
precomputed frame embeddings (B, n_frames, d_model) where the conv
subsampler would produce them. The encoder is a non-causal
self-attention stack (run without the flash kernel, as the reference's
``encode`` runs it); the decoder is the generic LM with interleaved
cross-attention blocks (each whisper layer's self+cross+mlp is a period
of two blocks: [self/no-ffn, cross/mlp]).

"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.distributed.mesh import stack_specs
from repro_torch.models import blocks, lm
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    encoder_period: Tuple[blocks.LayerSpec, ...]
    encoder_layers: int
    decoder: lm.ModelConfig
    d_model: int = 384
    dtype: object = torch.bfloat16

    @property
    def encoder_repeats(self) -> int:
        return self.encoder_layers // len(self.encoder_period)


def init_encdec(gen, cfg: EncDecConfig):
    """Params on ``gen.device`` from a seeded ``torch.Generator``."""
    return {
        "encoder": {"layers": [lm._stacked_init(gen, spec,
                                                cfg.encoder_repeats)
                               for spec in cfg.encoder_period],
                    "final_norm": layers.rmsnorm_init(cfg.d_model,
                                                      gen.device)},
        "decoder": lm.init_lm(gen, cfg.decoder),
    }


def encdec_logical_specs(cfg: EncDecConfig):
    return {
        "encoder": {"layers": [stack_specs(blocks.block_logical_specs(spec))
                               for spec in cfg.encoder_period],
                    "final_norm": {"scale": ("embed",)}},
        "decoder": lm.lm_logical_specs(cfg.decoder),
    }


def encode(params, frames, cfg: EncDecConfig):
    """frames: (B, T_frames, d_model) stub embeddings -> encoder output."""
    x = frames.to(cfg.dtype)
    enc = params["encoder"]
    for r in range(cfg.encoder_repeats):
        for j, spec in enumerate(cfg.encoder_period):
            x, _ = blocks.block_apply(lm._layer(enc["layers"][j], r), x,
                                      spec)
    return layers.rmsnorm(enc["final_norm"], x)


def encdec_loss(params, batch, cfg: EncDecConfig, *, act_constraint=None):
    """batch: dict(frames=(B,Tf,d), tokens=(B,T), labels=(B,T))."""
    enc_out = encode(params, batch["frames"], cfg)
    return lm.lm_loss(params["decoder"],
                      {"tokens": batch["tokens"], "labels": batch["labels"]},
                      cfg.decoder, cross_kv=enc_out,
                      act_constraint=act_constraint)


def init_decode_caches(params, cfg: EncDecConfig, frames, batch: int,
                       max_len: int):
    enc_out = encode(params, frames, cfg)
    return lm.init_caches(params["decoder"], cfg.decoder, batch, max_len,
                          cross_src=enc_out)


def decode_step(params, token, caches, index: int, cfg: EncDecConfig, *,
                logits_constraint=None):
    return lm.decode_step(params["decoder"], token, caches, index,
                          cfg.decoder, logits_constraint=logits_constraint)
