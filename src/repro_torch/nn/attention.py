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
the Pallas kernel in interpret mode off the TPU. The kernel is
forward-only, as the reference's is: ``use_flash=True`` under autograd
raises, and nothing falls back to the plain version.

On the mesh (DTensor activations, ``repro_torch.distributed.mesh``) the
projections run as DTensor matmuls and the attention core of each layer
runs per rank on its batch rows and heads (``mesh.head_parallel``): the
flash kernel on the local heads of a CUDA rank. Decode writes the new
K/V into the rank whose block of the cache holds the slot, and with a
``logits_constraint`` reduces over a cache whose sequence axis is split
(:func:`_attend_decode_sharded`, the distributed softmax); without one
each rank reads its batch rows' whole cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.distributed import mesh as mesh_lib
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


def attention_logical_specs(cfg: AttentionConfig):
    qspec = {"w": ("embed", "heads")}
    kvspec = {"w": ("embed", "kv_heads")}
    if cfg.use_qkv_bias:
        qspec = {"w": ("embed", "heads"), "b": ("heads",)}
        kvspec = {"w": ("embed", "kv_heads"), "b": ("kv_heads",)}
    return {"q": qspec, "k": dict(kvspec), "v": dict(kvspec),
            "o": {"w": ("heads", "embed")}}


# ---------------------------------------------------------------------------
# Core attend (the plain version; the flash kernel mirrors it)
# ---------------------------------------------------------------------------
def _repeat_kv(k, groups: int):
    """Each kv head repeated ``groups`` times in place (head h reads kv
    head h // groups)."""
    if groups == 1:
        return k
    b, t, hkv, dh = k.shape
    return k[:, :, :, None, :].expand(b, t, hkv, groups, dh) \
        .reshape(b, t, hkv * groups, dh)


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


def _local_heads(qf, kf, vf, kv_lo: int, cfg: AttentionConfig):
    """Flat projections (B, T, h·dh) -> heads (B, T, h, dh); where this
    rank holds all the kv heads but only some query heads, the kv heads of
    those queries' groups (from ``kv_lo``)."""
    dh = cfg.dh
    q = _split_heads(qf, qf.shape[-1] // dh, dh)
    k = _split_heads(kf, kf.shape[-1] // dh, dh)
    v = _split_heads(vf, vf.shape[-1] // dh, dh)
    kvl = max(1, q.shape[2] * cfg.num_kv_heads // cfg.num_heads)
    if k.shape[2] != kvl:
        k, v = k[:, :, kv_lo:kv_lo + kvl], v[:, :, kv_lo:kv_lo + kvl]
    return q, k, v


def _per_rank(fn, qf, kf, vf, cfg: AttentionConfig):
    """``fn(qf, kf, vf, kv_lo)``: on the mesh, per rank on its rows and
    heads (``mesh.head_parallel``)."""
    if mesh_lib.is_dtensor(qf):
        return mesh_lib.head_parallel(fn, qf, kf, vf, heads=cfg.num_heads,
                                      kv_heads=cfg.num_kv_heads)
    return fn(qf, kf, vf, 0)


def self_attention(params, x, cfg: AttentionConfig, *, positions=None,
                   use_flash: bool = False):
    """Prefill / training self-attention. x: (B, T, d_model)."""
    def core(qf, kf, vf, kv_lo):
        return _self_attend(qf, kf, vf, kv_lo, cfg, positions, use_flash)

    out = _per_rank(core, layers.linear(params["q"], x),
                    layers.linear(params["k"], x),
                    layers.linear(params["v"], x), cfg)
    return layers.linear(params["o"], out)


def _self_attend(qf, kf, vf, kv_lo, cfg: AttentionConfig, positions,
                 use_flash: bool):
    b, t, _ = qf.shape
    q, k, v = _local_heads(qf, kf, vf, kv_lo, cfg)
    if positions is None:
        positions = torch.arange(t, device=qf.device)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if use_flash:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "use_flash=True under autograd: the flash kernel is "
                "forward-only, as the reference's Pallas kernel is (no "
                "custom_vjp); train with use_flash=False")
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
    return out.reshape(b, t, -1)


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

    ``logits_constraint``: a sharding constraint applied to the (B, H, 1,
    slots) attention logits and probabilities. When the cache sequence
    axis is split over the mesh, constraining them to the same split makes
    the max, the sum and the PV partials small all-reduces over that axis
    (:func:`_attend_decode_sharded`) where the plain path would gather
    each batch row's whole K/V cache on its rank.
    """
    b = x.shape[0]
    dh = cfg.dh
    slots = cache["k"].shape[1]

    def rope_heads(qf, kf, vf):
        pos = torch.full((1,), cache_index, dtype=torch.int32,
                         device=qf.device)
        q = apply_rope(_split_heads(qf, cfg.num_heads, dh), pos,
                       theta=cfg.rope_theta)
        k = apply_rope(_split_heads(kf, cfg.num_kv_heads, dh), pos,
                       theta=cfg.rope_theta)
        return q, k, _split_heads(vf, cfg.num_kv_heads, dh)

    proj = [layers.linear(params[n], x) for n in ("q", "k", "v")]
    if mesh_lib.is_dtensor(proj[0]):
        q, k, v = mesh_lib.local_rows(rope_heads, *proj)
    else:
        q, k, v = rope_heads(*proj)
    slot = cache_index % slots
    mesh_lib.write_slot(cache["k"], slot, k)
    mesh_lib.write_slot(cache["v"], slot, v)
    mesh_lib.write_slot(cache["pos"], slot, torch.full(
        (1,), cache_index, dtype=torch.int32, device=x.device), dim=0)
    if logits_constraint is not None:
        out = _attend_decode_sharded(q, cache["k"], cache["v"], cfg,
                                     cache_index, cache["pos"],
                                     logits_constraint)
    else:
        def gathered(q, k, v, kv_pos):
            return attend(q, k, v, causal=True,
                          sliding_window=cfg.sliding_window,
                          softcap=cfg.attn_softcap, q_offset=cache_index,
                          kv_positions=kv_pos)
        if mesh_lib.is_dtensor(q):
            out = mesh_lib.local_rows(gathered, q, cache["k"], cache["v"],
                                      mesh_lib.whole(cache["pos"]))
        else:
            out = gathered(q, cache["k"], cache["v"], cache["pos"])
    out = layers.linear(params["o"], out.reshape(b, 1, cfg.num_heads * dh))
    return out, cache


def _reduced(x):
    """A partial max or sum reduced now, before a nonlinear op reads it."""
    return mesh_lib.reduce_partial(x) if mesh_lib.is_dtensor(x) else x


def _attend_decode_sharded(q, k, v, cfg: AttentionConfig, cache_index: int,
                           kv_positions, logits_constraint):
    """:func:`attend` of one query position with an explicit distributed
    softmax over the (split) cache sequence axis: the same math, with the
    logits and probabilities constrained so the max, the sum and the PV
    contraction reduce across the split. Works on plain tensors too (an
    identity constraint)."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    k_pos = kv_positions[None, :].long()                       # (1, S)
    mask = (k_pos >= 0) & (k_pos <= cache_index)
    if cfg.sliding_window is not None:
        mask = mask & (k_pos > cache_index - cfg.sliding_window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    logits = logits_constraint(logits)
    m = _reduced(torch.amax(logits, dim=-1, keepdim=True))  # all-reduce max
    p = logits_constraint(torch.exp(logits - m))
    s = _reduced(torch.sum(p, dim=-1, keepdim=True))        # all-reduce sum
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                      v.float())                           # psum partials
    return (pv / s.transpose(1, 2)).to(q.dtype)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder, llama-vision image layers)
# ---------------------------------------------------------------------------
def cross_attention_init(gen, cfg: AttentionConfig,
                         kv_dim: Optional[int] = None):
    dh = cfg.dh
    kv_dim = kv_dim or cfg.d_model
    return {
        "q": layers.linear_init(gen, cfg.d_model, cfg.num_heads * dh,
                                dtype=cfg.dtype),
        "k": layers.linear_init(gen, kv_dim, cfg.num_kv_heads * dh,
                                dtype=cfg.dtype),
        "v": layers.linear_init(gen, kv_dim, cfg.num_kv_heads * dh,
                                dtype=cfg.dtype),
        "o": layers.linear_init(gen, cfg.num_heads * dh, cfg.d_model,
                                dtype=cfg.dtype),
    }


def cross_attention(params, x, kv_src, cfg: AttentionConfig):
    """x: (B, Tq, d_model); kv_src: (B, Tk, kv_dim). No RoPE, no mask."""
    def core(qf, kf, vf, kv_lo):
        q, k, v = _local_heads(qf, kf, vf, kv_lo, cfg)
        out = attend(q, k, v, causal=False, softcap=cfg.attn_softcap)
        return out.reshape(qf.shape[0], qf.shape[1], -1)

    out = _per_rank(core, layers.linear(params["q"], x),
                    layers.linear(params["k"], kv_src),
                    layers.linear(params["v"], kv_src), cfg)
    return layers.linear(params["o"], out)
