"""Transformer blocks and the layer-period abstraction — the port of
``repro/models/blocks.py``.

A model is ``n_layers`` blocks arranged as ``repeats`` copies of a short
``period`` of :class:`LayerSpec`s (period 1 = plain llama; period 2 =
gemma2 local/global alternation). Params for each period position are
stacked along a leading repeats axis, as in the reference, so a JAX
params tree carries across leaf for leaf.

Ported: the attention mixer, the MLP ffn and gemma2's post-norms.
``mixer="ssm"``, ``mixer="cross_attn"`` and ``ffn="moe"`` raise
``NotImplementedError`` (ROADMAP queue 1 item 12): the SSM layer itself is
ported (``repro_torch.nn.ssm``), but no model path on the card runs it
yet. Left out: the logical-axis specs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn import attention as attn_mod
from repro_torch.nn import layers, ssm as ssm_mod


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block in the period."""
    mixer: str = "attn"                       # attn | ssm | cross_attn
    attn: Optional[attn_mod.AttentionConfig] = None
    ssm: Optional[ssm_mod.SSMConfig] = None
    ffn: str = "mlp"                          # mlp | moe | none
    mlp: Optional[layers.MLPConfig] = None
    moe: Optional[object] = None
    post_norm: bool = False                   # gemma2-style post-block norms
    gated_cross: bool = False                 # llama-vision tanh-gated cross
    cross_kv_dim: Optional[int] = None
    d_model: int = 0
    dtype: object = torch.bfloat16


def _check_ported(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer={spec.mixer!r} blocks are not ported yet (ROADMAP queue 1 "
            f"item 12); the SSM layer runs through repro_torch.nn.ssm."
            f"ssm_layer")
    if spec.ffn not in ("mlp", "none"):
        raise NotImplementedError(
            f"ffn={spec.ffn!r} is not ported yet (ROADMAP queue 1 item 12)")


def block_init(gen, spec: LayerSpec):
    _check_ported(spec)
    dev = gen.device
    p = {"norm1": layers.rmsnorm_init(spec.d_model, dev),
         "mixer": attn_mod.attention_init(gen, spec.attn)}
    if spec.post_norm:
        p["norm1_post"] = layers.rmsnorm_init(spec.d_model, dev)
    if spec.ffn != "none":
        p["norm2"] = layers.rmsnorm_init(spec.d_model, dev)
        p["ffn"] = layers.mlp_init(gen, spec.mlp)
        if spec.post_norm:
            p["norm2_post"] = layers.rmsnorm_init(spec.d_model, dev)
    return p


def _ffn(p, spec: LayerSpec, x):
    """The residual ffn half of a block (identity without an ffn)."""
    if spec.ffn == "none":
        return x
    h = layers.rmsnorm(p["norm2"], x)
    h = layers.mlp(p["ffn"], h, activation=spec.mlp.activation)
    if spec.post_norm:
        h = layers.rmsnorm(p["norm2_post"], h)
    return x + h


def block_apply(p, x, spec: LayerSpec, *, positions=None,
                use_flash: bool = False):
    """Returns (x, moe_aux_or_None). x: (B, T, d_model)."""
    _check_ported(spec)
    h = layers.rmsnorm(p["norm1"], x)
    h = attn_mod.self_attention(p["mixer"], h, spec.attn,
                                positions=positions, use_flash=use_flash)
    if spec.post_norm:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn(p, spec, x + h), None


def init_block_cache(spec: LayerSpec, batch: int, max_len: int,
                     device="cpu"):
    """Cache for one block: sliding-window layers allocate only
    ``window`` slots (a ring buffer)."""
    _check_ported(spec)
    window = spec.attn.sliding_window
    slots = min(max_len, window) if window else max_len
    return attn_mod.init_kv_cache(spec.attn, batch, slots, device=device)


def block_decode(p, x, cache, index: int, spec: LayerSpec):
    """One-token decode. x: (B, 1, d). Returns (x, cache); the cache is
    updated in place."""
    _check_ported(spec)
    h = layers.rmsnorm(p["norm1"], x)
    h, cache = attn_mod.decode_self_attention(p["mixer"], h, cache, index,
                                              spec.attn)
    if spec.post_norm:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn(p, spec, x + h), cache
