"""Transformer / SSM / MoE blocks and the layer-period abstraction — the
port of ``repro/models/blocks.py``.

A model is ``n_layers`` blocks arranged as ``repeats`` copies of a short
``period`` of heterogeneous :class:`LayerSpec`s (period 1 = plain llama;
period 2 = gemma2 local/global alternation; period 5 = llama-vision
4×self + 1×cross; zamba2 = 2×ssm + a *shared* attention block). Params for
each period position are stacked along a leading repeats axis, as in the
reference, so a JAX params tree carries across leaf for leaf.

Mixers: self-attention (``attn``), the Mamba-2 SSM layer (``ssm``, run
without the SSD kernel, as the reference's block runs it) and
cross-attention (``cross_attn``, with llama-vision's tanh gates); ffns: the
MLP, MoE (``moe``, which returns the aux terms) or none. Each block has
its logical-axis specs (params and decode cache) for the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import mesh as mesh_lib
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import layers, moe as moe_mod, ssm as ssm_mod


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block in the period."""
    mixer: str = "attn"                       # attn | ssm | cross_attn
    attn: Optional[attn_mod.AttentionConfig] = None
    ssm: Optional[ssm_mod.SSMConfig] = None
    ffn: str = "mlp"                          # mlp | moe | none
    mlp: Optional[layers.MLPConfig] = None
    moe: Optional[moe_mod.MoEConfig] = None
    post_norm: bool = False                   # gemma2-style post-block norms
    gated_cross: bool = False                 # llama-vision tanh-gated cross
    cross_kv_dim: Optional[int] = None
    d_model: int = 0
    dtype: object = torch.bfloat16


def block_init(gen, spec: LayerSpec):
    dev = gen.device
    p = {"norm1": layers.rmsnorm_init(spec.d_model, dev)}
    if spec.mixer == "attn":
        p["mixer"] = attn_mod.attention_init(gen, spec.attn)
    elif spec.mixer == "cross_attn":
        p["mixer"] = attn_mod.cross_attention_init(
            gen, spec.attn, kv_dim=spec.cross_kv_dim)
        if spec.gated_cross:
            p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=dev)
            p["gate_ffn"] = torch.zeros((), dtype=torch.float32, device=dev)
    elif spec.mixer == "ssm":
        p["mixer"] = ssm_mod.ssm_init(gen, spec.ssm)
    else:
        raise ValueError(spec.mixer)
    if spec.post_norm:
        p["norm1_post"] = layers.rmsnorm_init(spec.d_model, dev)
    if spec.ffn != "none":
        p["norm2"] = layers.rmsnorm_init(spec.d_model, dev)
        if spec.ffn == "mlp":
            p["ffn"] = layers.mlp_init(gen, spec.mlp)
        else:
            p["ffn"] = moe_mod.moe_init(gen, spec.moe)
        if spec.post_norm:
            p["norm2_post"] = layers.rmsnorm_init(spec.d_model, dev)
    return p


def block_logical_specs(spec: LayerSpec):
    s = {"norm1": {"scale": ("embed",)}}
    if spec.mixer in ("attn", "cross_attn"):
        s["mixer"] = attn_mod.attention_logical_specs(spec.attn)
        if spec.mixer == "cross_attn":
            s["mixer"] = {"q": {"w": ("embed", "heads")},
                          "k": {"w": (None, "kv_heads")},
                          "v": {"w": (None, "kv_heads")},
                          "o": {"w": ("heads", "embed")}}
            if spec.gated_cross:
                s["gate_attn"] = ()
                s["gate_ffn"] = ()
    else:
        s["mixer"] = ssm_mod.ssm_logical_specs(spec.ssm)
    if spec.post_norm:
        s["norm1_post"] = {"scale": ("embed",)}
    if spec.ffn != "none":
        s["norm2"] = {"scale": ("embed",)}
        s["ffn"] = (layers.mlp_logical_specs(spec.mlp) if spec.ffn == "mlp"
                    else moe_mod.moe_logical_specs(spec.moe))
        if spec.post_norm:
            s["norm2_post"] = {"scale": ("embed",)}
    return s


def block_cache_logical_specs(spec: LayerSpec):
    """Logical axes for one block's decode cache (parallel tree)."""
    if spec.mixer == "attn":
        return {"k": ("cache_batch", "cache_seq", "kv_heads", None),
                "v": ("cache_batch", "cache_seq", "kv_heads", None),
                "pos": ("cache_seq",)}
    if spec.mixer == "ssm":
        return {"conv": ("cache_batch", None, "mlp"),
                "state": ("cache_batch", "heads", None, None)}
    # cross_attn: precomputed K/V over the (short) modality sequence
    return {"k": ("cache_batch", None, "kv_heads", None),
            "v": ("cache_batch", None, "kv_heads", None)}


def _gathered(h):
    return mesh_lib.gather_rows(h) if mesh_lib.is_dtensor(h) else h


def _gate(p, name: str, spec: LayerSpec, h):
    """llama-vision's tanh gate on a cross block's branch."""
    if spec.gated_cross:
        return h * torch.tanh(p[name]).to(h.dtype)
    return h


def _ffn(p, spec: LayerSpec, x):
    """The residual ffn half of a block: (x, moe aux or None)."""
    if spec.ffn == "none":
        return x, None
    h = _gathered(layers.rmsnorm(p["norm2"], x))
    aux = None
    if spec.ffn == "mlp":
        h = layers.mlp(p["ffn"], h, activation=spec.mlp.activation)
    else:
        h, aux = moe_mod.moe_layer(p["ffn"], h, spec.moe)
    h = _gate(p, "gate_ffn", spec, h)
    if spec.post_norm:
        h = layers.rmsnorm(p["norm2_post"], h)
    return x + h, aux


def _mixer_out(p, spec: LayerSpec, x, h):
    """The residual add of the mixer's output h (post-norm first)."""
    if spec.post_norm:
        h = layers.rmsnorm(p["norm1_post"], h)
    return x + h


def block_apply(p, x, spec: LayerSpec, *, cross_kv=None, positions=None,
                use_flash: bool = False):
    """Returns (x, moe_aux_or_None). x: (B, T, d_model)."""
    p = mesh_lib.unshard(p, x)
    # on the mesh the normed input is gathered along the sequence once
    # for all the mixer's products (a no-op off the mesh)
    h = _gathered(layers.rmsnorm(p["norm1"], x))
    if spec.mixer == "attn":
        h = attn_mod.self_attention(p["mixer"], h, spec.attn,
                                    positions=positions, use_flash=use_flash)
    elif spec.mixer == "cross_attn":
        h = attn_mod.cross_attention(p["mixer"], h, cross_kv, spec.attn)
        h = _gate(p, "gate_attn", spec, h)
    else:
        h = ssm_mod.ssm_layer(p["mixer"], h, spec.ssm)
    return _ffn(p, spec, _mixer_out(p, spec, x, h))


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------
def init_block_cache(spec: LayerSpec, batch: int, max_len: int,
                     device="cpu"):
    """Cache for one self-attention or SSM block: sliding-window layers
    allocate only ``window`` slots (a ring buffer). Cross-attention blocks
    hold K/V projected once from the source (``lm.init_caches``)."""
    if spec.mixer == "attn":
        window = spec.attn.sliding_window
        slots = min(max_len, window) if window else max_len
        return attn_mod.init_kv_cache(spec.attn, batch, slots, device=device)
    if spec.mixer == "ssm":
        return ssm_mod.init_ssm_cache(spec.ssm, batch, device=device)
    raise ValueError(f"{spec.mixer} blocks take their cache from "
                     f"lm.init_caches(cross_src=...)")


def block_decode(p, x, cache, index: int, spec: LayerSpec, *,
                 logits_constraint=None):
    """One-token decode of a self-attention or SSM block. x: (B, 1, d).
    Returns (x, cache); the cache is updated in place."""
    p = mesh_lib.unshard(p, x)
    h = layers.rmsnorm(p["norm1"], x)
    if spec.mixer == "attn":
        h, cache = attn_mod.decode_self_attention(
            p["mixer"], h, cache, index, spec.attn,
            logits_constraint=logits_constraint)
    elif spec.mixer == "ssm":
        h, new = ssm_mod.ssm_decode_step(p["mixer"], h, cache, spec.ssm)
        for name in ("conv", "state"):
            mesh_lib.assign(cache[name], new[name])
    else:
        raise ValueError(f"{spec.mixer} blocks decode through "
                         f"lm._decode_cross")
    return _ffn(p, spec, _mixer_out(p, spec, x, h))[0], cache
