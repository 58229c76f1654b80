"""GRU scan on the card — wrappers of ``csrc/gru.cu``.

Replaces ``repro/kernels/gru/kernel.py``: ``forward`` launches ``gru_fwd``
(for ``_gru_forward``), ``backward`` launches ``_gru_backward``'s three
phases (the gate recompute ``gru_bwd_gates``, the serial adjoint chain
``gru_bwd_chain``, the dW_h/db_h sums ``gru_bwd_weights`` and
``gru_bwd_weights_sum``), and :class:`GRUScan` pairs them as one
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``). Gates
are recomputed in the backward, not stored; resets get no gradient.
Any hidden width whose tile fits a block's shared memory: up to
``RESIDENT_HIDDEN`` W_h stays in registers or shared memory for all T
steps (``gru_fwd``, ``gru_bwd_chain``); above it W_h is streamed from
L2 every step (``gru_fwd_stream``, ``gru_bwd_chain_stream``), with the
rows of a tile halved (down to 2) until h (and the chain's dgh) fit:
up to H=7,264 both ways.

Every tensor carries a leading agent axis A (the reference vmaps the
scan over agents), so each agent has its own W_h. ``LAUNCHES`` counts
the launches of each wrapper, and under ``gru_forward_stream`` and
``gru_backward_stream`` those that ran the streaming kernels
(:func:`route`); ``SHAPE_LAUNCHES`` counts the same launches by
(A, T, B, H) and ``STREAM_LAUNCHES`` by the CUDA stream they were queued
on (its ``cuda_stream`` handle), for the chip run to show that the main
path went through the kernels, at which shapes, and that the overlapped
collect launched its own on a stream other than the driver's. The loop
driver's collect worker and the driver launch from two threads, so the
counts are updated under a lock.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.kernels.gru import ref

LAUNCHES = {"gru_forward": 0, "gru_backward": 0, "gru_forward_stream": 0,
            "gru_backward_stream": 0}
SHAPE_LAUNCHES = {"gru_forward": {}, "gru_backward": {}}
STREAM_LAUNCHES = {"gru_forward": {}, "gru_backward": {}}
_count_lock = threading.Lock()
RESIDENT_HIDDEN = 128            # csrc/gru.cu's RESIDENT_HIDDEN
MAX_TILE_ROWS = 8                # batch rows a block carries through T
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block


def tile_rows(batch: int, agents: int = 1, min_blocks: int = 1) -> int:
    """Batch rows per block (the batch tile): 2, 4 or 8, the smallest
    that holds the batch when it is smaller, then halved (down to 2)
    while the grid of agents x tiles has fewer than ``min_blocks`` blocks:
    a step's latency falls with the rows a block carries, so a card with
    idle SMs is better used by smaller tiles."""
    rows = 2
    while rows < min(batch, MAX_TILE_ROWS):
        rows *= 2
    while rows > 2 and agents * -(-batch // rows) < min_blocks:
        rows //= 2
    return rows


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_inputs(gi, wh, bh, h0, resets):
    a, t, b, h3 = gi.shape
    hdim = h3 // 3
    check_tensor("gi", gi, (a, t, b, 3 * hdim))
    check_tensor("wh", wh, (a, hdim, 3 * hdim))
    check_tensor("bh", bh, (a, 3 * hdim))
    check_tensor("h0", h0, (a, b, hdim))
    check_tensor("resets", resets, (a, t, b))
    if hdim < 1:
        raise ValueError(f"GRU hidden {hdim} must be >= 1")
    return a, t, b, hdim


def route(hdim: int) -> str:
    """The kernels a launch at hidden ``hdim`` runs, as ``csrc/gru.cu``
    picks them: ``"resident"`` (``gru_fwd``, ``gru_bwd_chain``, W_h held
    for all T steps) up to RESIDENT_HIDDEN, ``"stream"``
    (``gru_fwd_stream``, ``gru_bwd_chain_stream``) above."""
    return "stream" if hdim > RESIDENT_HIDDEN else "resident"


def fit_rows(rows: int, hdim: int, smem_bytes) -> int:
    """``rows`` halved (down to 2) while ``smem_bytes(hdim, rows)`` is
    more than a block's shared memory; only the streaming kernels
    shrink, the resident ones fit at any rows."""
    while rows > 2 and route(hdim) == "stream" and \
            smem_bytes(hdim, rows) > MAX_SMEM_BYTES:
        rows //= 2
    return rows


def _check_smem(nbytes: int, what: str, hdim: int):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"GRU {what} kernel needs {nbytes} bytes of shared memory at "
            f"hidden {hdim}; a block has {MAX_SMEM_BYTES}")


def _count(name: str, shape, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with _count_lock:
        LAUNCHES[name] += 1
        if route(shape[-1]) == "stream":
            LAUNCHES[f"{name}_stream"] += 1
        for table, k in ((SHAPE_LAUNCHES, shape), (STREAM_LAUNCHES, stream)):
            table[name][k] = table[name].get(k, 0) + 1


def forward(gi, wh, bh, h0, resets):
    """Launch the forward scan: hs (A,T,B,H)."""
    a, t, b, hdim = _check_inputs(gi, wh, bh, h0, resets)
    hs = torch.empty((a, t, b, hdim), dtype=torch.float32, device=gi.device)
    if hs.numel() == 0:
        return hs
    ext = build.extension()
    # smaller tiles while agents x tiles leaves SMs idle
    rows = fit_rows(tile_rows(b, a, _sm_count(gi.device)), hdim,
                    ext.gru_forward_smem_bytes)
    _check_smem(ext.gru_forward_smem_bytes(hdim, rows), "forward", hdim)
    ext.gru_forward(gi, wh, bh, h0, resets, hs, rows)
    _count("gru_forward", (a, t, b, hdim), gi.device)
    return hs


def backward(gi, wh, bh, h0, resets, hs, g):
    """Launch the reverse-time adjoint: (dgi, dwh, dbh, dh0)."""
    a, t, b, hdim = _check_inputs(gi, wh, bh, h0, resets)
    check_tensor("hs", hs, (a, t, b, hdim))
    check_tensor("g", g, (a, t, b, hdim))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=gi.device)
    dgi, dh0 = new(a, t, b, 3 * hdim), new(a, b, hdim)
    dwh, dbh = new(a, hdim, 3 * hdim), new(a, 3 * hdim)
    if a * t * b == 0:   # no step: no gradient reaches the weights or h0
        return dgi, dwh.zero_(), dbh.zero_(), dh0.zero_()
    ext = build.extension()
    # the chain's 8 lanes a unit own a row each at 8 rows a tile; fewer
    # rows repeat its gate algebra, worth it only on a card half idle
    rows = fit_rows(tile_rows(b, a, _sm_count(gi.device) // 2), hdim,
                    ext.gru_backward_smem_bytes)
    _check_smem(ext.gru_backward_smem_bytes(hdim, rows), "backward", hdim)
    # scratch: the recomputed gh for the chain, its r gate and the partial
    # sums over slices of rows for dW_h/db_h
    gh, rgate = new(a, t, b, 3 * hdim), new(a, t, b, hdim)
    part = new(ext.gru_backward_part_floats(a, t, b, hdim))
    ext.gru_backward(gi, wh, bh, h0, resets, hs, g, gh, rgate, part, dgi,
                     dwh, dbh, dh0, rows)
    _count("gru_backward", (a, t, b, hdim), gi.device)
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
