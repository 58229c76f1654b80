"""Flash attention on the card — the wrapper of
``csrc/flash_attention_sm90.cu`` and ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py``:
:func:`flash_attention_bhsd` launches a kernel for
``flash_attention_bhsd`` / ``_attn_kernel`` on CUDA tensors and runs the
plain version (``ref.attention_bhsd``) on CPU tensors. Forward only, as
the reference (it has no VJP).

The kernel is chosen by dtype. bfloat16 q/k/v go to ``flash_fwd_sm90``,
on the tensor cores (``wgmma``, bf16 products summed in float32, p
rounded to bf16 for p·v); float32 q/k/v go to ``flash_fwd``, on fp32
FFMA, since the tensor cores would need TF32 for them. Both take head_dim
64, 128 or 256; the output is in q's dtype. A failed build or launch
raises: there is no fallback. ``LAUNCHES["flash_attention"]`` counts
every launch, ``LAUNCHES["flash_fwd_sm90"]`` and ``LAUNCHES["flash_fwd"]``
each kernel's. The reference's ``block_q``/``block_k``/``interpret``
arguments are gone: the kernels fix their tiles and there is no
interpreter on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0, "flash_fwd_sm90": 0, "flash_fwd": 0}
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128, 256)


def forward(q, k, v, *, causal: bool = True,
            sliding_window: Optional[int] = None,
            softcap: Optional[float] = None):
    """Launch the kernel: q (BH, Tq, D); k, v (BH_kv, Tk, D) ->
    (BH, Tq, D) in q's dtype."""
    bh, tq, d = q.shape
    bh_kv, tk = k.shape[0], k.shape[1]
    check_tensor("q", q, (bh, tq, d), DTYPES)
    check_tensor("k", k, (bh_kv, tk, d), (q.dtype,))
    check_tensor("v", v, (bh_kv, tk, d), (q.dtype,))
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if bh % bh_kv:
        raise ValueError(f"{bh} query rows are not a multiple of {bh_kv} "
                         f"kv rows")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    ext = build.extension()
    out = torch.empty_like(q)
    args = (q, k, v, out, bool(causal), int(sliding_window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(d))
    if q.dtype == torch.bfloat16:
        # the tensor maps of its loads need 16-byte aligned rows
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        ext.flash_attention_sm90(*args)
        LAUNCHES["flash_fwd_sm90"] += 1
    else:
        ext.flash_attention(*args)
        LAUNCHES["flash_fwd"] += 1
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         sliding_window: Optional[int] = None,
                         softcap: Optional[float] = None):
    """q: (BH, Tq, D); k, v: (BH_kv, Tk, D) with BH = BH_kv · group. The
    caller flattens batch×heads; GQA group = BH // BH_kv. CUDA tensors run
    the kernel; CPU tensors run the plain version."""
    kw = dict(causal=causal, sliding_window=sliding_window, softcap=softcap)
    if q.is_cuda:
        return forward(q, k, v, **kw)
    return ref.attention_bhsd(q, k, v, **kw)
