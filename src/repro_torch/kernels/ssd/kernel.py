"""Mamba-2 SSD intra-chunk block on the card — the wrapper of
``csrc/ssd.cu``.

Replaces ``repro/kernels/ssd/kernel.py``: :func:`ssd_intra_chunk`
launches ``ssd_chunk`` (for ``ssd_intra_chunk`` / ``_ssd_chunk_kernel``)
on CUDA tensors and runs the plain version (``ref.intra_chunk``) on CPU
tensors. Forward only, as the reference. ``LAUNCHES`` counts the
launches.

It returns what the reference's code returns, ``(y, states,
chunk_decay)``; the fourth output its docstring promises
(``cum_logdecay``) is not computed there either. The kernel takes xw, b
and c in one dtype (float32 or bfloat16) and la in float32, chunk a
multiple of 16 up to 128, head_dim and state size multiples of 4 up to
128.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.ssd import ref

LAUNCHES = {"ssd_intra_chunk": 0}
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block


def heads_per_block(bsz: int, nc: int, h: int, sms: int) -> int:
    """G heads share one block's C·Bᵀ: the largest divisor of h that
    still gives the grid two blocks per SM (1 if none does)."""
    for g in range(h, 0, -1):
        if h % g == 0 and bsz * nc * (h // g) >= 2 * sms:
            return g
    return 1


def forward(xw, la, b, c, *, chunk: int):
    """Launch the kernel; see :func:`ssd_intra_chunk` for the contract."""
    bsz, t, h, p = xw.shape
    n = b.shape[-1]
    check_tensor("xw", xw, (bsz, t, h, p), DTYPES)
    check_tensor("la", la, (bsz, t, h))
    check_tensor("b", b, (bsz, t, n), (xw.dtype,))
    check_tensor("c", c, (bsz, t, n), (xw.dtype,))
    if t % chunk or chunk % 16 or not 16 <= chunk <= 128:
        raise ValueError(f"chunk {chunk} must be a multiple of 16 up to 128 "
                         f"that divides T={t}")
    if p % 4 or p > 128 or n % 4 or n > 128:
        raise ValueError(f"head_dim {p} and state {n} must be multiples of "
                         f"4 up to 128")
    ext = build.extension()
    smem = ext.ssd_smem_bytes(chunk, p, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"SSD kernel needs {smem} bytes of shared memory "
                         f"at chunk {chunk}, P {p}, N {n}; a block has "
                         f"{MAX_SMEM_BYTES}")
    nc = t // chunk
    sms = torch.cuda.get_device_properties(xw.device).multi_processor_count
    g = heads_per_block(bsz, nc, h, sms)
    y = torch.empty_like(xw)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                         device=xw.device)
    chunk_decay = torch.empty((bsz, nc, h), dtype=torch.float32,
                              device=xw.device)
    ext.ssd_intra_chunk(xw, la, b, c, y, states, chunk_decay, chunk, g)
    LAUNCHES["ssd_intra_chunk"] += 1
    return y, states, chunk_decay


def ssd_intra_chunk(xw, la, b, c, *, chunk: int):
    """xw: (B, T, H, P) dt-weighted inputs; la: (B, T, H) log decays;
    b, c: (B, T, N). Returns (y_diag (B,T,H,P) in xw's dtype, states
    (B,nc,H,P,N) f32, chunk_decay (B,nc,H) f32). CUDA tensors run the
    kernel; CPU tensors run the plain version."""
    if xw.is_cuda:
        return forward(xw, la, b, c, chunk=chunk)
    return ref.intra_chunk(xw, la, b, c, chunk=chunk)
