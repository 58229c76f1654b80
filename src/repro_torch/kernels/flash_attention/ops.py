"""Public flash-attention op: (B, T, H, D) layout, GQA — the port of
``repro/kernels/flash_attention/ops.py``."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel as k_mod


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: (B, T, H, D); k, v: (B, T, Hkv, D) -> (B, T, H, D)."""
    b, tq, h, d = q.shape
    hkv = k.shape[2]
    # GQA index math in the kernel assumes head-major flattening per batch:
    # row b*h + i maps to kv row b*hkv + i//group, which equals (b*h+i)//group
    # only when flattened batch-major. Reorder so heads vary fastest.
    qf = q.transpose(1, 2).reshape(b * h, tq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, k.shape[1], d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, v.shape[1], d).contiguous()
    out = k_mod.flash_attention_bhsd(qf, kf, vf, causal=causal,
                                     sliding_window=sliding_window,
                                     softcap=softcap)
    return out.reshape(b, h, tq, d).transpose(1, 2)
