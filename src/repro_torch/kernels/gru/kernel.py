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
steps (``gru_fwd``, ``gru_bwd_chain``); above it both directions keep
W_h resident across a thread-block cluster up to ``CLUSTER_HIDDEN``
(``gru_fwd_cluster``, ``gru_bwd_chain_cluster``: each CTA holds its
units' columns, at the plan of :func:`cluster_plan`), and otherwise W_h
is streamed from L2 every step (``gru_fwd_stream``,
``gru_bwd_chain_stream``), with the rows of a tile halved (down to 2)
until h (and the chain's dgh) fit: up to H=7,264 both ways.

Every tensor carries a leading agent axis A (the reference vmaps the
scan over agents), so each agent has its own W_h. ``LAUNCHES`` counts
the launches of each wrapper, under ``gru_forward_cluster`` and
``gru_backward_cluster`` those that ran the cluster kernels and under
``gru_forward_stream`` and ``gru_backward_stream`` those that ran the
streaming kernels (:func:`forward_route`, :func:`backward_route`);
``SHAPE_LAUNCHES`` counts the same launches by
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
            "gru_backward_stream": 0, "gru_forward_cluster": 0,
            "gru_backward_cluster": 0}
SHAPE_LAUNCHES = {"gru_forward": {}, "gru_backward": {}}
STREAM_LAUNCHES = {"gru_forward": {}, "gru_backward": {}}
_count_lock = threading.Lock()
_MAX_ACTIVE = {}     # (device, direction, hidden, CTAs, rows) -> clusters
RESIDENT_HIDDEN = 128            # csrc/gru.cu's RESIDENT_HIDDEN
MAX_TILE_ROWS = 8                # batch rows a block carries through T
MAX_SMEM_BYTES = 232448          # dynamic shared memory of one H100 block
# csrc/gru.cu's cluster forward: CTAs of 32 units, tiles of 64 down to 8
# rows, threads of 8 rows x 4 units, 256 a CTA, clusters of up to 16
CLUSTER_UNITS = 32
CLUSTER_ROWS = (64, 32, 16, 8)
CLUSTER_THREADS, CLUSTER_RT, CLUSTER_UT = 256, 8, 4
MAX_CLUSTER = 16
CLUSTER_HIDDEN = 512             # the widest hidden with a cluster plan
# the fewest steps at which the cluster forward beats the streaming one on
# a grid of more clusters than the card holds at once, by the most CTAs a
# cluster: it first loads the CTAs' W_h slices, which the streaming kernel
# reads as it goes. Measured at one width a band (NVIDIA H100 80GB HBM3,
# benchmarks/torch_tree_times.py --gru-sweep): hidden 160 (5 CTAs) and
# 256 (8) from T=2, 384 (12) from T=4, 512 (16) from T=8; the widths
# between take their band's value unmeasured.
CLUSTER_MIN_STEPS = {8: 2, 12: 4, MAX_CLUSTER: 8}
# the same edge for the backward's chain (the whole backward timed with
# gru_bwd_chain_cluster and with gru_bwd_chain_stream, --gru-sweep, same
# card): on grids of many waves the cluster chain was faster from T=1 at
# hidden 160 (0.757 of the stream's time), 256 (0.696) and 384 (0.927),
# and at 512 from T=2 (1.034 at T=1, 0.890 at T=2)
CLUSTER_MIN_STEPS_BWD = {12: 1, MAX_CLUSTER: 2}
CHAIN_KB = 64                    # csrc/gru.cu's CHAIN_KB


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


def route(hdim: int, direction: str = "forward") -> str:
    """The kernel a launch at hidden ``hdim`` runs in ``direction``
    (``"forward"`` or ``"backward"``): ``"resident"`` (``gru_fwd``,
    ``gru_bwd_chain``, W_h held by one block for all T steps) up to
    RESIDENT_HIDDEN; above it ``"cluster"`` (``gru_fwd_cluster``,
    ``gru_bwd_chain_cluster``) up to CLUSTER_HIDDEN, and ``"stream"``
    (``gru_fwd_stream``, ``gru_bwd_chain_stream``) for the rest: the
    route of a long sequence; :func:`forward_route` and
    :func:`backward_route` give a launch's."""
    if hdim <= RESIDENT_HIDDEN:
        return "resident"
    if hdim <= CLUSTER_HIDDEN:
        return "cluster"
    return "stream"


def _launch_route(shape, sm_count, max_active, direction, min_steps):
    """:func:`route`'s kernel, except that a cluster launch of fewer than
    ``min_steps`` steps (by the most CTAs a cluster) whose A x tiles
    clusters do not all fit on the card at once streams."""
    a, t, b, hdim = shape
    kind = route(hdim, direction)
    if kind != "cluster":
        return kind
    ctas, rows = cluster_plan(hdim, b, a, sm_count, direction)
    fewest = next(n for c, n in sorted(min_steps.items()) if ctas <= c)
    one_wave = a * -(-b // rows) <= max_active(hdim, ctas, rows)
    return "cluster" if one_wave or t >= fewest else "stream"


def forward_route(shape, sm_count: int, max_active) -> str:
    """The kernel the forward launches at shape (A, T, B, H) on a card of
    ``sm_count`` SMs that holds ``max_active(hdim, ctas, rows)`` clusters
    of a plan at once (``gru_forward_cluster_max_active``):
    :func:`route`'s, except that a cluster launch of fewer than
    CLUSTER_MIN_STEPS steps whose A x tiles clusters do not all fit on
    the card at once streams. A pure function of the shape and the
    card."""
    return _launch_route(shape, sm_count, max_active, "forward",
                         CLUSTER_MIN_STEPS)


def backward_route(shape, sm_count: int, max_active) -> str:
    """The chain the backward launches at shape (A, T, B, H), as
    :func:`forward_route` decides the forward's, at the backward's plan
    (``gru_backward_cluster_max_active``) and CLUSTER_MIN_STEPS_BWD."""
    return _launch_route(shape, sm_count, max_active, "backward",
                         CLUSTER_MIN_STEPS_BWD)


def _max_active(ext, device, direction: str = "forward"):
    """``max_active`` of :func:`forward_route` (or of
    :func:`backward_route`) for ``device``, each plan asked of the card
    once."""
    query = (ext.gru_forward_cluster_max_active if direction == "forward"
             else ext.gru_backward_cluster_max_active)

    def ask(hdim, ctas, rows):
        key = (device.index, direction, hdim, ctas, rows)
        if key not in _MAX_ACTIVE:
            with torch.cuda.device(device):
                _MAX_ACTIVE[key] = query(hdim, ctas, rows)
        return _MAX_ACTIVE[key]
    return ask


def cluster_ks(rows: int) -> int:
    """Lanes of a unit group over the reduction axis in the cluster
    forward: as many as keep a CTA at CLUSTER_THREADS threads."""
    return CLUSTER_THREADS * CLUSTER_RT * CLUSTER_UT // (CLUSTER_UNITS * rows)


def cluster_smem_bytes(hdim: int, rows: int) -> int:
    """Shared memory of one CTA of the cluster forward, as ``csrc/gru.cu``
    lays it out: HP rows of its 3 x CLUSTER_UNITS columns of W_h, and h
    double-buffered, ``rows`` rows of HP floats (HP: hidden rounded up to
    4 x the lanes, zeros past it)."""
    ks = cluster_ks(rows)
    hp = -(-hdim // (4 * ks)) * (4 * ks)
    return 4 * (3 * CLUSTER_UNITS + 2 * rows) * hp


def cluster_chain_smem_bytes(hdim: int, ctas: int, rows: int) -> int:
    """Shared memory of one CTA of the cluster chain, as ``csrc/gru.cu``
    lays it out: KP rows (hidden rounded up to CHAIN_KB, zeros past it)
    of its 3 x CLUSTER_UNITS columns of W_h, and two buffers of ``ctas``
    slots of ``rows`` x CLUSTER_UNITS partial sums."""
    kp = -(-hdim // CHAIN_KB) * CHAIN_KB
    return 4 * (3 * CLUSTER_UNITS * kp + 2 * ctas * rows * CLUSTER_UNITS)


def cluster_plan(hdim: int, batch: int = CLUSTER_ROWS[0], agents: int = 1,
                 min_ctas: int = 1, direction: str = "forward"):
    """(CTAs a cluster, rows a tile) of the cluster forward (or, with
    ``direction="backward"``, of the cluster chain) at hidden ``hdim``,
    or None where it takes no plan (hidden above CLUSTER_HIDDEN or not
    above RESIDENT_HIDDEN). A CTA takes CLUSTER_UNITS units, so
    hidden/32 CTAs, rounded up, up to MAX_CLUSTER. The rows: the batch's
    (a power of two from 8 to 64), halved while a CTA's shared memory
    does not fit a block or the grid of agents x tiles x CTAs has fewer
    than ``min_ctas`` CTAs; at 8 rows any hidden up to 512 fits both
    ways. A pure function of the shape."""
    ctas = -(-hdim // CLUSTER_UNITS)
    if hdim <= RESIDENT_HIDDEN or ctas > MAX_CLUSTER:
        return None
    smem = (lambda r: cluster_smem_bytes(hdim, r)) if direction == \
        "forward" else (lambda r: cluster_chain_smem_bytes(hdim, ctas, r))
    rows = CLUSTER_ROWS[-1]
    while rows < min(batch, CLUSTER_ROWS[0]):
        rows *= 2
    while rows > CLUSTER_ROWS[-1] and (
            smem(rows) > MAX_SMEM_BYTES or
            agents * -(-batch // rows) * ctas < min_ctas):
        rows //= 2
    return ctas, rows


def fit_rows(rows: int, hdim: int, smem_bytes) -> int:
    """``rows`` halved (down to 2) while ``smem_bytes(hdim, rows)`` is
    more than a block's shared memory; only the streaming kernels
    (above RESIDENT_HIDDEN) shrink, the resident ones fit at any rows."""
    while rows > 2 and hdim > RESIDENT_HIDDEN and \
            smem_bytes(hdim, rows) > MAX_SMEM_BYTES:
        rows //= 2
    return rows


def _check_smem(nbytes: int, what: str, hdim: int):
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"GRU {what} kernel needs {nbytes} bytes of shared memory at "
            f"hidden {hdim}; a block has {MAX_SMEM_BYTES}")


def _count(name: str, shape, device, kind: str = None) -> None:
    """Count one launch of wrapper ``name`` at ``shape`` on route ``kind``
    (by default :func:`route`'s at its hidden width)."""
    if kind is None:
        kind = route(shape[-1], "forward" if name == "gru_forward"
                     else "backward")
    stream = torch.cuda.current_stream(device).cuda_stream
    with _count_lock:
        LAUNCHES[name] += 1
        if kind != "resident":
            LAUNCHES[f"{name}_{kind}"] += 1
        for table, k in ((SHAPE_LAUNCHES, shape), (STREAM_LAUNCHES, stream)):
            table[name][k] = table[name].get(k, 0) + 1


def forward(gi, wh, bh, h0, resets):
    """Launch the forward scan: hs (A,T,B,H)."""
    a, t, b, hdim = _check_inputs(gi, wh, bh, h0, resets)
    hs = torch.empty((a, t, b, hdim), dtype=torch.float32, device=gi.device)
    if hs.numel() == 0:
        return hs
    ext = build.extension()
    sms = _sm_count(gi.device)
    kind = forward_route((a, t, b, hdim), sms, _max_active(ext, gi.device))
    if kind == "cluster":
        ext.gru_forward_cluster(gi, wh, bh, h0, resets, hs,
                                *cluster_plan(hdim, b, a, sms))
    else:
        # smaller tiles while agents x tiles leaves SMs idle
        rows = fit_rows(tile_rows(b, a, sms), hdim,
                        ext.gru_forward_smem_bytes)
        _check_smem(ext.gru_forward_smem_bytes(hdim, rows), "forward", hdim)
        ext.gru_forward(gi, wh, bh, h0, resets, hs, rows)
    _count("gru_forward", (a, t, b, hdim), gi.device, kind)
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
    sms = _sm_count(gi.device)
    kind = backward_route((a, t, b, hdim), sms,
                          _max_active(ext, gi.device, "backward"))
    if kind == "cluster":
        ctas, rows = cluster_plan(hdim, b, a, sms, "backward")
    else:
        # the chain's 8 lanes a unit own a row each at 8 rows a tile;
        # fewer rows repeat its gate algebra, worth it only on a card half
        # idle
        ctas, rows = 0, fit_rows(tile_rows(b, a, sms // 2), hdim,
                                 ext.gru_backward_smem_bytes)
        _check_smem(ext.gru_backward_smem_bytes(hdim, rows), "backward",
                    hdim)
    # scratch: the recomputed gh for the chain, its r gate and the partial
    # sums over slices of rows for dW_h/db_h
    gh, rgate = new(a, t, b, 3 * hdim), new(a, t, b, hdim)
    part = new(ext.gru_backward_part_floats(a, t, b, hdim))
    ext.gru_backward(gi, wh, bh, h0, resets, hs, g, gh, rgate, part, dgi,
                     dwh, dbh, dh0, rows, ctas)
    _count("gru_backward", (a, t, b, hdim), gi.device, kind)
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
