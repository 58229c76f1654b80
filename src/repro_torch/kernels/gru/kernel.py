"""GRU scan on the card — wrappers of ``csrc/gru.cu``.

Replaces ``repro/kernels/gru/kernel.py``: ``forward`` launches ``gru_fwd``
(for ``_gru_forward``), ``backward`` launches ``gru_bwd`` (for
``_gru_backward``), and :class:`GRUScan` pairs them as one
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``). Gates
are recomputed in the backward, not stored; resets get no gradient.

Every tensor carries a leading agent axis A (the reference vmaps the
scan over agents), so each agent has its own W_h. ``LAUNCHES`` counts
the launches of each wrapper, for the chip run to show that the main
path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.gru import ref

LAUNCHES = {"gru_forward": 0, "gru_backward": 0}
# threads of one block are (H, block_rows); cap a block at 512 threads
MAX_BLOCK_THREADS = 512
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block


def block_rows(batch: int, hdim: int) -> int:
    """Batch rows per block (the batch tile)."""
    return max(1, min(batch, MAX_BLOCK_THREADS // hdim))


def _check_inputs(gi, wh, bh, h0, resets):
    a, t, b, h3 = gi.shape
    hdim = h3 // 3
    check_tensor("gi", gi, (a, t, b, 3 * hdim))
    check_tensor("wh", wh, (a, hdim, 3 * hdim))
    check_tensor("bh", bh, (a, 3 * hdim))
    check_tensor("h0", h0, (a, b, hdim))
    check_tensor("resets", resets, (a, t, b))
    if hdim > MAX_BLOCK_THREADS:
        raise ValueError(f"GRU hidden {hdim} exceeds {MAX_BLOCK_THREADS}")
    return a, t, b, hdim


def _check_smem(nbytes: int, what: str, hdim: int):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"GRU {what} kernel needs {nbytes} bytes of shared memory at "
            f"hidden {hdim}; a block has {MAX_SMEM_BYTES}")


def forward(gi, wh, bh, h0, resets):
    """Launch the forward scan: hs (A,T,B,H)."""
    a, t, b, hdim = _check_inputs(gi, wh, bh, h0, resets)
    ext = build.extension()
    rows = block_rows(b, hdim)
    _check_smem(ext.gru_forward_smem_bytes(hdim, rows), "forward", hdim)
    hs = torch.empty((a, t, b, hdim), dtype=torch.float32, device=gi.device)
    ext.gru_forward(gi, wh, bh, h0, resets, hs, rows)
    LAUNCHES["gru_forward"] += 1
    return hs


def backward(gi, wh, bh, h0, resets, hs, g):
    """Launch the reverse-time adjoint: (dgi, dwh, dbh, dh0)."""
    a, t, b, hdim = _check_inputs(gi, wh, bh, h0, resets)
    check_tensor("hs", hs, (a, t, b, hdim))
    check_tensor("g", g, (a, t, b, hdim))
    ext = build.extension()
    rows = block_rows(b, hdim)
    _check_smem(ext.gru_backward_smem_bytes(hdim, rows), "backward", hdim)
    tiles = -(-b // rows)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=gi.device)
    dgi, dh0 = new(a, t, b, 3 * hdim), new(a, b, hdim)
    dwh, dbh = new(a, hdim, 3 * hdim), new(a, 3 * hdim)
    if tiles == 1:       # the single tile's partial sums are the result
        dwh_part, dbh_part = dwh.view(a, 1, hdim, 3 * hdim), dbh.view(a, 1, -1)
    else:
        dwh_part, dbh_part = new(a, tiles, hdim, 3 * hdim), new(a, tiles,
                                                                3 * hdim)
    ext.gru_backward(gi, wh, bh, h0, resets, hs, g, dgi, dwh_part, dbh_part,
                     dh0, dwh, dbh, rows)
    LAUNCHES["gru_backward"] += 1
    return dgi, dwh, dbh, dh0


class GRUScan(torch.autograd.Function):
    """hs = scan(gi, wh, bh, h0, resets), differentiable in (gi, wh, bh,
    h0) through the backward kernel."""

    @staticmethod
    def forward(ctx, gi, wh, bh, h0, resets):
        hs = forward(gi, wh, bh, h0, resets)
        ctx.save_for_backward(gi, wh, bh, h0, resets, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        dgi, dwh, dbh, dh0 = backward(*ctx.saved_tensors, g.contiguous())
        return dgi, dwh, dbh, dh0, None


def gru_scan(gi, wh, bh, h0, resets):
    """gi (A,T,B,3H) = x.W_i + b_i; wh (A,H,3H); bh (A,3H); h0 (A,B,H);
    resets (A,T,B) -> hs (A,T,B,H), float32. CUDA tensors run the kernels;
    CPU tensors run the plain version (``ref.gru_scan``)."""
    if gi.is_cuda:
        return GRUScan.apply(gi, wh, bh, h0, resets)
    return ref.gru_scan(gi, wh, bh, h0, resets)
