"""Flash attention on the card — the wrapper of
``csrc/flash_attention_sm90.cu`` and ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py``:
:func:`flash_attention_bhsd` launches a kernel for
``flash_attention_bhsd`` / ``_attn_kernel`` on CUDA tensors and runs the
plain version (``ref.attention_bhsd``) on CPU tensors. Forward only, as
the reference (it has no VJP).

The kernel is chosen by dtype and head_dim (:func:`route`). bfloat16
q/k/v at head_dim 64, 128 or 256 go to ``flash_fwd_sm90``, on the tensor
cores (``wgmma``, bf16 products summed in float32, p split into two bf16
terms for p·v); bfloat16 at any other head_dim up to 256 goes to
``flash_fwd_sm90_padded``, the same kernel at the head_dim rounded up to
64 (its tensor maps read zeros past the true head_dim; a head_dim that is
no multiple of 8 is first copied into rows padded to 8, scratch the
wrapper allocates); bfloat16 at 257..512 goes to ``flash_fwd_sm90_wide``,
the same products at the head_dim rounded up to 64 with O split by
columns over two warpgroups (the same padding and scratch). float32
q/k/v go to fp32 FFMA, since the tensor cores would need TF32 for them:
``flash_fwd`` at head_dim 64, 128 or 256, ``flash_fwd_padded`` at any
other head_dim up to 512, padded up to the next of 64, 128, 192, 256,
384, 512. Above 512 the padded kernel's smallest tiles leave no room in
a block's shared memory and the wrapper raises. The output is in q's
dtype. A failed build or launch raises: there is no fallback.
``LAUNCHES["flash_attention"]`` counts every launch, ``LAUNCHES[route]``
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

ROUTES = ("flash_fwd_sm90", "flash_fwd_sm90_padded", "flash_fwd",
          "flash_fwd_padded", "flash_fwd_sm90_wide")
LAUNCHES = {"flash_attention": 0, **{r: 0 for r in ROUTES}}
DTYPES = (torch.float32, torch.bfloat16)
SM90_HEAD_DIMS = (64, 128, 256)  # flash_fwd_sm90 (bf16), flash_fwd (f32)
SM90_PADDED_MAX = 256            # flash_fwd_sm90_padded: bf16 up to here
WIDE_QUERIES, WIDE_KEYS = 64, 32  # flash_fwd_sm90_wide's q and k/v tiles
FFMA_HEAD_DIMS = (64, 128, 192, 256, 384, 512)  # flash_fwd_padded's
MAX_HEAD_DIM = FFMA_HEAD_DIMS[-1]
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block


def route(dtype, d: int) -> str:
    """The kernel a launch goes to: at head_dim 64, 128 or 256
    ``"flash_fwd_sm90"`` for bf16 and ``"flash_fwd"`` for float32; bf16
    at the other head_dims up to SM90_PADDED_MAX
    ``"flash_fwd_sm90_padded"`` and above it ``"flash_fwd_sm90_wide"``;
    ``"flash_fwd_padded"`` for the other float32 head_dims."""
    bf16 = dtype == torch.bfloat16
    if d in SM90_HEAD_DIMS:
        return "flash_fwd_sm90" if bf16 else "flash_fwd"
    if bf16:
        return ("flash_fwd_sm90_padded" if d <= SM90_PADDED_MAX
                else "flash_fwd_sm90_wide")
    return "flash_fwd_padded"


def ffma_smem_bytes(d: int) -> int:
    """Shared memory of one ``flash_fwd_padded`` block at head_dim ``d``
    (1..512), padded as ``csrc/flash_attention.cu`` pads it: q and k tiles of D+4
    floats a row, v of D, p of keys+4; 64-row tiles up to D=256, 32
    above."""
    dp = next(c for c in FFMA_HEAD_DIMS if c >= d)
    rows = 64 if dp <= 256 else 32
    return 4 * (2 * rows * (dp + 4) + rows * dp + rows * (rows + 4))


def wide_smem_bytes(d: int) -> int:
    """Shared memory of one ``flash_fwd_sm90_wide`` block at head_dim
    ``d`` (257..512), as ``csrc/flash_attention_sm90.cu``'s ``WideSmem``
    lays it out at DP = d rounded up to 64: 1,024 B of alignment slack, Q
    (64 rows of DP bf16), two stages of K (32 rows) and of V (two halves
    of ceil(DP/128) 4-KB boxes), four 64 x 32 float32 S partials and nine
    mbarriers."""
    dp = -(-d // 64) * 64
    v_stage = 2 * -(-dp // 128) * WIDE_KEYS * 128
    return (1024 + WIDE_QUERIES * dp * 2 + 2 * (WIDE_KEYS * dp * 2 + v_stage)
            + 4 * WIDE_QUERIES * WIDE_KEYS * 4 + 8 * 9)


def check_head_dim(d: int) -> None:
    """Raise for a head_dim no kernel takes: below 1, or above
    MAX_HEAD_DIM."""
    if d < 1:
        raise ValueError(f"flash attention head_dim must be >= 1, got {d}")
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention kernel takes head_dim up to {MAX_HEAD_DIM}, "
            f"got {d}: at {MAX_HEAD_DIM} its 32-row q, k and v tiles "
            f"already take {ffma_smem_bytes(MAX_HEAD_DIM)} of the "
            f"{MAX_SMEM_BYTES} bytes of shared memory a block has")


def _pad_scratch(q, k, v):
    """The rows ``flash_fwd_sm90_padded`` and ``flash_fwd_sm90_wide``
    read when the head_dim is no multiple of 8 (a tensor map's rows are
    16-byte strides): q, k and v copied into rows of the head_dim rounded
    up to 8; empty otherwise."""
    d = q.shape[-1]
    d8 = -(-d // 8) * 8
    if d8 == d:
        return (q.new_empty(0),) * 3
    new = lambda x: torch.empty((*x.shape[:-1], d8), dtype=x.dtype,
                                device=x.device)
    return new(q), new(k), new(v)


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
    check_head_dim(d)
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
    kernel = route(q.dtype, d)
    if kernel.startswith("flash_fwd_sm90") and d % 8 == 0:
        # the tensor maps of its loads read q, k, v in place
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    if kernel == "flash_fwd_sm90":
        ext.flash_attention_sm90(*args)
    elif kernel in ("flash_fwd_sm90_padded", "flash_fwd_sm90_wide"):
        launch = (ext.flash_attention_sm90_padded
                  if kernel == "flash_fwd_sm90_padded"
                  else ext.flash_attention_sm90_wide)
        launch(q, k, v, out, *_pad_scratch(q, k, v), *args[4:])
    else:
        ext.flash_attention(*args)
    LAUNCHES[kernel] += 1
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
