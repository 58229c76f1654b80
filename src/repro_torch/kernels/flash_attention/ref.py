"""Plain torch versions of flash attention: masked softmax attention with
GQA, causal / sliding-window masks and logit softcap — delegates to the
port's :func:`repro_torch.nn.attention.attend`, as the reference's
``ref.py`` delegates to its ``attend``. The kernel's CPU path and its
oracle on the card."""
from __future__ import annotations

from typing import Optional

from repro_torch.nn import attention as attn_mod


def attention(q, k, v, *, causal: bool = True,
              sliding_window: Optional[int] = None,
              softcap: Optional[float] = None):
    """q: (B, T, H, D); k, v: (B, T, Hkv, D) -> (B, T, H, D)."""
    return attn_mod.attend(q, k, v, causal=causal,
                           sliding_window=sliding_window, softcap=softcap)


def attention_bhsd(q, k, v, *, causal: bool = True,
                   sliding_window: Optional[int] = None,
                   softcap: Optional[float] = None):
    """The kernel's own layout: q (BH, Tq, D); k, v (BH_kv, Tk, D); query
    row i reads kv row i // (BH // BH_kv). That is :func:`attention` over
    one batch whose heads are the flattened rows."""
    out = attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                    v.transpose(0, 1)[None], causal=causal,
                    sliding_window=sliding_window, softcap=softcap)
    return out[0].transpose(0, 1)
