"""Vision-language backbone (llama-3.2-vision style) — the port of
``repro/models/vlm.py``.

The vision tower is a stub, as in the reference: the caller feeds
precomputed patch embeddings (B, n_patches, vision_dim), which the
tanh-gated cross-attention layers of the decoder read (a period of five:
four self-attention blocks and one gated cross-attention block).
"""
from __future__ import annotations

from repro_torch.models import lm


def vlm_loss(params, batch, cfg: lm.ModelConfig, *, act_constraint=None):
    """batch: dict(tokens, labels, patches=(B, P, vision_dim))."""
    return lm.lm_loss(params, batch, cfg, cross_kv=batch["patches"],
                      act_constraint=act_constraint)


def init_decode_caches(params, cfg: lm.ModelConfig, patches, batch: int,
                       max_len: int):
    return lm.init_caches(params, cfg, batch, max_len,
                          cross_src=patches.to(cfg.dtype))


decode_step = lm.decode_step
