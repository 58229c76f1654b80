"""Attention — the port of ``repro/nn/attention.py``: GQA with RoPE,
causal / sliding-window masks, logit softcap, and a KV-cache decode path.

Shapes
------
* activations  x : (B, T, d_model)
* q            : (B, T, H, Dh)
* k, v         : (B, T, Hkv, Dh)   with H % Hkv == 0 (GQA)
* KV cache     : dict(k=(B, S, Hkv, Dh), v=(B, S, Hkv, Dh), pos=(S,))

All matmuls accumulate in fp32. :func:`attend` is the plain version the
flash kernel (``repro_torch.kernels.flash_attention``) is held to.
``self_attention(use_flash=True)`` launches that kernel on CUDA tensors
and runs its plain version on CPU tensors, as the reference's flag runs
the Pallas kernel in interpret mode off the TPU.

Left out: ``_attend_decode_sharded`` (the mesh-sharded decode softmax;
``decode_self_attention`` raises if handed a ``logits_constraint``),
cross-attention (whisper, llama-vision) and the logical-axis specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.nn import layers

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    rope_theta: float = 10_000.0
    use_qkv_bias: bool = False              # qwen-style
    sliding_window: Optional[int] = None    # gemma2 local layers
    attn_softcap: Optional[float] = None    # gemma2 logit soft-capping
    causal: bool = True                     # False for encoder self-attn
    dtype: object = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(dh: int, theta: float, device="cpu"):
    """Inverse frequencies, shape (dh//2,), fp32."""
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float):
    """x: (B, T, H, Dh); positions: (B, T) or (T,) integer."""
    dh = x.shape[-1]
    inv_freq = rope_frequencies(dh, theta, x.device)           # (Dh/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv_freq              # (B, T, Dh/2)
    sin = torch.sin(ang)[:, :, None, :]                        # (B, T, 1, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def attention_init(gen, cfg: AttentionConfig):
    dh = cfg.dh
    kw = dict(use_bias=cfg.use_qkv_bias, dtype=cfg.dtype)
    return {
        "q": layers.linear_init(gen, cfg.d_model, cfg.num_heads * dh, **kw),
        "k": layers.linear_init(gen, cfg.d_model, cfg.num_kv_heads * dh,
                                **kw),
        "v": layers.linear_init(gen, cfg.d_model, cfg.num_kv_heads * dh,
                                **kw),
        "o": layers.linear_init(gen, cfg.num_heads * dh, cfg.d_model,
                                use_bias=False, dtype=cfg.dtype),
    }


# ---------------------------------------------------------------------------
# Core attend (the plain version; the flash kernel mirrors it)
# ---------------------------------------------------------------------------
def _repeat_kv(k, groups: int):
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def make_mask(q_len: int, kv_len: int, *, causal: bool,
              sliding_window: Optional[int], q_offset=0, kv_positions=None,
              device="cpu"):
    """Boolean mask (q_len, kv_len); True = attend.

    ``kv_positions`` overrides the default contiguous key positions — used
    by the ring-buffer decode cache, where slot order is rotated and slots
    holding stale/unwritten entries carry position -1.
    """
    if kv_positions is not None:
        device = kv_positions.device
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    if kv_positions is None:
        k_pos = torch.arange(kv_len, device=device)[None, :]
        mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    else:
        k_pos = kv_positions[None, :].long()
        mask = k_pos >= 0
    if causal:
        mask = mask & (k_pos <= q_pos)
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    return mask


def _scores(q, k, scale, softcap):
    """(B, H, Tq, Tk) fp32 logits of q (B,Tq,H,D) against k (B,Tk,H,D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def attend(q, k, v, *, causal: bool = True,
           sliding_window: Optional[int] = None,
           softcap: Optional[float] = None, q_offset=0, kv_positions=None):
    """Scaled dot-product attention with GQA broadcast.

    q: (B, Tq, H, Dh); k, v: (B, Tk, Hkv, Dh). Returns (B, Tq, H, Dh).
    """
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = 1.0 / math.sqrt(dh)
    logits = _scores(q, k, scale, softcap)
    mask = make_mask(tq, k.shape[1], causal=causal,
                     sliding_window=sliding_window, q_offset=q_offset,
                     kv_positions=kv_positions, device=q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def attend_chunked(q, k, v, *, causal: bool = True,
                   sliding_window: Optional[int] = None,
                   softcap: Optional[float] = None, block_k: int = 1024):
    """Flash-style online-softmax attention in plain torch: a loop over
    key blocks carrying (running max, normaliser, accumulator), so the
    (T×T) score matrix is never materialised (same FLOPs as :func:`attend`,
    O(T·block_k) memory)."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    tk = k.shape[1]
    if tk % block_k != 0:
        return attend(q, k, v, causal=causal, sliding_window=sliding_window,
                      softcap=softcap)
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = 1.0 / math.sqrt(dh)
    q_pos = torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, dh), dtype=torch.float32, device=q.device)
    for ki in range(tk // block_k):
        kblk = k[:, ki * block_k:(ki + 1) * block_k]
        vblk = v[:, ki * block_k:(ki + 1) * block_k]
        s = _scores(q, kblk, scale, softcap)
        k_pos = ki * block_k + torch.arange(block_k, device=q.device)
        mask = torch.ones((tq, block_k), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if sliding_window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - sliding_window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask[None, None], p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(),
                          vblk.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Full layers
# ---------------------------------------------------------------------------
def _split_heads(x, n, dh):
    return x.reshape(x.shape[0], x.shape[1], n, dh)


def self_attention(params, x, cfg: AttentionConfig, *, positions=None,
                   use_flash: bool = False):
    """Prefill / training self-attention. x: (B, T, d_model)."""
    b, t, _ = x.shape
    dh = cfg.dh
    q = _split_heads(layers.linear(params["q"], x), cfg.num_heads, dh)
    k = _split_heads(layers.linear(params["k"], x), cfg.num_kv_heads, dh)
    v = _split_heads(layers.linear(params["v"], x), cfg.num_kv_heads, dh)
    if positions is None:
        positions = torch.arange(t, device=x.device)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if use_flash:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(
            q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
            softcap=cfg.attn_softcap)
    elif t >= 2048:
        # flash-equivalent plain path: never materialises the (T, T) scores
        out = attend_chunked(q, k, v, causal=cfg.causal,
                             sliding_window=cfg.sliding_window,
                             softcap=cfg.attn_softcap)
    else:
        out = attend(q, k, v, causal=cfg.causal,
                     sliding_window=cfg.sliding_window,
                     softcap=cfg.attn_softcap)
    return layers.linear(params["o"], out.reshape(b, t, cfg.num_heads * dh))


def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int,
                  dtype=None, device="cpu"):
    """Position-tracking KV cache.

    ``max_len`` may be smaller than the sequence length, in which case the
    cache is a ring buffer (sliding-window layers allocate only ``window``
    slots). ``pos`` records the absolute position stored in each slot (-1 =
    empty); attention masks are derived from it, so the rotated slot order
    of the ring is immaterial (softmax is order-invariant).
    """
    dtype = dtype or cfg.dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((max_len,), -1, dtype=torch.int32,
                              device=device)}


def decode_self_attention(params, x, cache, cache_index: int,
                          cfg: AttentionConfig, *, logits_constraint=None):
    """One-token decode. x: (B, 1, d_model); cache_index: the absolute
    position of the new token (a Python int). Returns (out, cache).

    RoPE is applied to K at write time, so cached keys are
    position-final. The cache is updated IN PLACE and returned (the
    reference's serve step donates it; the same memory is reused).
    """
    if logits_constraint is not None:
        raise NotImplementedError(
            "the mesh-sharded decode softmax is not ported (ROADMAP queue 1 "
            "item 14)")
    b = x.shape[0]
    dh = cfg.dh
    slots = cache["k"].shape[1]
    q = _split_heads(layers.linear(params["q"], x), cfg.num_heads, dh)
    k = _split_heads(layers.linear(params["k"], x), cfg.num_kv_heads, dh)
    v = _split_heads(layers.linear(params["v"], x), cfg.num_kv_heads, dh)
    pos = torch.full((1,), cache_index, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, theta=cfg.rope_theta)
    k = apply_rope(k, pos, theta=cfg.rope_theta)
    slot = cache_index % slots
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    cache["pos"][slot] = cache_index
    out = attend(q, cache["k"], cache["v"], causal=True,
                 sliding_window=cfg.sliding_window, softcap=cfg.attn_softcap,
                 q_offset=cache_index, kv_positions=cache["pos"])
    out = layers.linear(params["o"], out.reshape(b, 1, cfg.num_heads * dh))
    return out, cache
