"""Mamba-2 SSD intra-chunk block on the card — the wrapper of
``csrc/ssd_sm90.cu`` and ``csrc/ssd.cu``.

Replaces ``repro/kernels/ssd/kernel.py``: :func:`ssd_intra_chunk`
launches a kernel for ``ssd_intra_chunk`` / ``_ssd_chunk_kernel`` on CUDA
tensors and runs the plain version (``ref.intra_chunk``) on CPU tensors.
Forward only, as the reference.

It returns what the reference's code returns, ``(y, states,
chunk_decay)``; the fourth output its docstring promises
(``cum_logdecay``) is not computed there either. The kernel is chosen by
dtype and shape (:func:`route`): bfloat16 inputs at head_dim 64, chunk 64
or 128 and state 64 or 128 (mamba2-780m's and zamba2-1.2b's layers) go to
``ssd_chunk_sm90``, on the tensor cores (bf16 products summed in float32,
M and X·w split into bf16 hi + lo), and at chunk 256 to
``ssd_chunk_sm90_long`` (the same products, C·Bᵀ recomputed a 64 x 64
tile at a time for each head); float32 inputs and the other shapes go
to fp32 FFMA, since the tensor cores would need TF32 for float32:
``ssd_chunk`` where its whole-chunk tiles fit (chunk a multiple of 16 up
to 128, head_dim and state multiples of 4 up to 128, within a block's
shared memory), ``ssd_chunk_tiled`` (two kernels, ``ssd_tiled_y`` and
``ssd_tiled_state``) at every other chunk that divides T and every head_dim
and state, as the reference takes them. All take xw, b and c in one dtype
and la in float32. A refused or failed launch raises: no route gives way
to another. ``LAUNCHES["ssd_intra_chunk"]`` counts every launch,
``LAUNCHES[route]`` each route's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.ssd import ref

LAUNCHES = {"ssd_intra_chunk": 0, "ssd_chunk_sm90": 0, "ssd_chunk": 0,
            "ssd_chunk_tiled": 0, "ssd_chunk_sm90_long": 0}
DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block
SM90_HEAD_DIMS, SM90_CHUNKS, SM90_STATES = (64,), (64, 128), (64, 128)
SM90_MAX_HEADS = 16              # heads a block of ssd_chunk_sm90
SM90_LONG_CHUNKS = (256,)        # ssd_chunk_sm90_long's chunks
SM90_LONG_MAX_HEADS = 8          # heads a block of ssd_chunk_sm90_long


def ffma_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of one ``ssd_chunk`` block (``csrc/ssd.cu``'s
    ``smem_floats``): C·Bᵀ, C then M, B with padded rows, X and cs."""
    return 4 * (chunk * chunk + chunk * max(chunk, n) + chunk * (n + 4)
                + chunk * p + chunk)


def route(dtype, p: int, n: int, chunk: int) -> str:
    """The kernel a launch goes to: ``"ssd_chunk_sm90"`` and
    ``"ssd_chunk_sm90_long"`` for bf16 at the shapes they take,
    ``"ssd_chunk"`` where its whole-chunk tiles fit, ``"ssd_chunk_tiled"``
    otherwise."""
    if dtype == torch.bfloat16 and p in SM90_HEAD_DIMS and n in SM90_STATES:
        if chunk in SM90_CHUNKS:
            return "ssd_chunk_sm90"
        if chunk in SM90_LONG_CHUNKS:
            return "ssd_chunk_sm90_long"
    if (chunk % 16 == 0 and chunk <= 128 and p % 4 == 0 and p <= 128
            and n % 4 == 0 and n <= 128
            and ffma_smem_bytes(chunk, p, n) <= MAX_SMEM_BYTES):
        return "ssd_chunk"
    return "ssd_chunk_tiled"


def check_shape(t: int, p: int, n: int, chunk: int) -> None:
    """Raise for a shape no route takes: a chunk that does not divide T,
    an empty head or state."""
    if chunk < 1 or t % chunk:
        raise ValueError(f"chunk {chunk} must be >= 1 and divide T={t}")
    if p < 1 or n < 1:
        raise ValueError(f"head_dim {p} and state {n} must be >= 1")


def heads_per_block(bsz: int, nc: int, h: int, sms: int) -> int:
    """``ssd_chunk``: G heads share one block's C·Bᵀ; the largest divisor
    of h that still gives the grid two blocks per SM (1 if none does)."""
    for g in range(h, 0, -1):
        if h % g == 0 and bsz * nc * (h // g) >= 2 * sms:
            return g
    return 1


def heads_per_block_sm90(bsz: int, nc: int, h: int, sms: int) -> int:
    """``ssd_chunk_sm90``: one block an SM (its shared memory allows no
    second), so G is the most heads (up to 16) that still gives every SM a
    block; the last group of heads may be short."""
    return max(1, min(SM90_MAX_HEADS, bsz * nc * h // sms))


def heads_per_block_long(bsz: int, nc: int, h: int, sms: int) -> int:
    """``ssd_chunk_sm90_long``: as :func:`heads_per_block_sm90`, up to 8
    heads a block (its shared memory holds their cs and w)."""
    return max(1, min(SM90_LONG_MAX_HEADS, bsz * nc * h // sms))


def forward(xw, la, b, c, *, chunk: int):
    """Launch the kernel; see :func:`ssd_intra_chunk` for the contract."""
    bsz, t, h, p = xw.shape
    n = b.shape[-1]
    check_tensor("xw", xw, (bsz, t, h, p), DTYPES)
    check_tensor("la", la, (bsz, t, h))
    check_tensor("b", b, (bsz, t, n), (xw.dtype,))
    check_tensor("c", c, (bsz, t, n), (xw.dtype,))
    check_shape(t, p, n, chunk)
    kernel = route(xw.dtype, p, n, chunk)
    ext = build.extension()
    smem = {"ssd_chunk_sm90": lambda: ext.ssd_sm90_smem_bytes(chunk, p, n),
            "ssd_chunk_sm90_long":
                lambda: ext.ssd_sm90_long_smem_bytes(chunk, p, n),
            "ssd_chunk": lambda: ext.ssd_smem_bytes(chunk, p, n),
            "ssd_chunk_tiled": lambda: ext.ssd_tiled_smem_bytes(chunk, p)
            }[kernel]()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"SSD kernel needs {smem} bytes of shared memory "
                         f"at chunk {chunk}, P {p}, N {n}; a block has "
                         f"{MAX_SMEM_BYTES}")
    nc = t // chunk
    sms = torch.cuda.get_device_properties(xw.device).multi_processor_count
    y = torch.empty_like(xw)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                         device=xw.device)
    chunk_decay = torch.empty((bsz, nc, h), dtype=torch.float32,
                              device=xw.device)
    if kernel in ("ssd_chunk_sm90", "ssd_chunk_sm90_long"):
        # the tensor maps of its loads and stores need 16-byte alignment
        for name, x in (("xw", xw), ("b", b), ("c", c)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        if kernel == "ssd_chunk_sm90":
            ext.ssd_intra_chunk_sm90(xw, la, b, c, y, states, chunk_decay,
                                     chunk,
                                     heads_per_block_sm90(bsz, nc, h, sms))
        else:
            ext.ssd_intra_chunk_sm90_long(
                xw, la, b, c, y, states, chunk_decay, chunk,
                heads_per_block_long(bsz, nc, h, sms))
    elif kernel == "ssd_chunk_tiled":
        ext.ssd_intra_chunk_tiled(xw, la, b, c, y, states, chunk_decay, chunk)
    else:
        ext.ssd_intra_chunk(xw, la, b, c, y, states, chunk_decay, chunk,
                            heads_per_block(bsz, nc, h, sms))
    LAUNCHES[kernel] += 1
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
