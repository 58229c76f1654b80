"""Collective helpers of the sharded runtime — the port of
``repro/distributed/collectives.py``.

Thin, named wrappers over ``torch.distributed`` so the higher layers
(the sharded runner, the region-decomposed GS) read like the paper's
pseudocode. Each takes the :class:`~repro_torch.distributed.runtime.
ShardMesh` whose group it runs on (the reference's ``axis_name``), works
on a tree of tensors leaf by leaf and returns new tensors (its inputs
are left as they were). On a one-shard mesh each is the identity, as
the reference's collectives are over a one-device axis.

The group is gloo (``repro_torch.distributed.bootstrap``). On CUDA
tensors gloo carries ``all_reduce``, ``broadcast``, ``all_gather`` and
``reduce_scatter_tensor`` itself, but not point-to-point traffic: on an
H100 with torch 2.11, ``batch_isend_irecv`` and ``send``/``recv`` of a
CUDA tensor fail ("writev ... Bad address"), the writing rank raising or
aborting its process. So the ring shift (:func:`ppermute_ring`, the halo
exchange's one op) stages CUDA tensors through pinned host buffers, here
and nowhere else; ``tests/test_torch_cuda.py`` holds every wrapper here
on CUDA tensors.
:data:`STATS` counts the halo exchanges, the ring shifts, the bytes they
move and the bytes staged (both directions, sent and received), and the
host seconds spent in the shifts (staging copies included: each waits
for the device), for ``chip_smoke.py`` and the benchmarks;
:func:`reset_stats` zeroes it.
"""
from __future__ import annotations

import time

import torch

from repro_torch.tree import tree_map

STATS = {"halo_exchanges": 0, "p2p_calls": 0, "p2p_bytes": 0,
         "staged_bytes": 0, "p2p_s": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


def _dist():
    import torch.distributed as dist
    return dist


def tree_psum(tree, mesh):
    """Sum over shards, every leaf (an all-reduce)."""
    if mesh.n_shards == 1:
        return tree

    def one(x):
        y = x.clone()
        _dist().all_reduce(y, group=mesh.group)
        return y
    return tree_map(one, tree)


def tree_pmean(tree, mesh):
    """Mean over shards, every leaf."""
    if mesh.n_shards == 1:
        return tree
    return tree_map(lambda x: x / mesh.n_shards, tree_psum(tree, mesh))


def tree_all_gather(tree, mesh):
    """Every shard's leaf, in rank order, concatenated along the leading
    (agent) axis."""
    n = mesh.n_shards
    if n == 1:
        return tree

    def one(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        _dist().all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)
    return tree_map(one, tree)


def tree_psum_scatter(tree, mesh, *, axis: int = 0):
    """Reduce-scatter: each shard ends with its slice (along ``axis``) of
    the sum — half the bytes of an all-reduce when the consumer is
    itself sharded."""
    n = mesh.n_shards
    if n == 1:
        return tree

    def one(x):
        moved = x.movedim(axis, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
        _dist().reduce_scatter_tensor(out, moved, group=mesh.group)
        return out.movedim(0, axis)
    return tree_map(one, tree)


def pbroadcast(tree, mesh, root: int = 0):
    """Every shard gets shard ``root``'s leaves."""
    if mesh.n_shards == 1:
        return tree

    def one(x):
        y = x.clone()
        _dist().broadcast(y, src=root, group=mesh.group)
        return y
    return tree_map(one, tree)


def ppermute_ring(x, mesh, *, shift: int = 1):
    """Ring shift: shard i sends ``x`` to shard i+shift and returns what
    shard i-shift sent (mod the shard count), as one
    ``batch_isend_irecv``. A CUDA tensor travels through pinned host
    buffers (gloo carries no point-to-point traffic on the card).

    On a one-shard mesh the ring is a shard sending to itself, which a
    process group cannot do: the shift is the identity and dispatches
    nothing (:func:`halo_exchange` still counts the exchange)."""
    if mesh.n_shards == 1:
        return x
    dist = _dist()
    t0 = time.perf_counter()
    n, rank = mesh.n_shards, mesh.rank
    staged = x.device.type == "cuda"
    send = x.detach().contiguous()
    if staged:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        send = host.copy_(send)
    recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=staged)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (rank + shift) % n, group=mesh.group),
        dist.P2POp(dist.irecv, recv, (rank - shift) % n, group=mesh.group)])
    for req in reqs:
        req.wait()
    nbytes = send.numel() * send.element_size()
    STATS["p2p_calls"] += 1
    STATS["p2p_bytes"] += 2 * nbytes
    if staged:
        STATS["staged_bytes"] += 2 * nbytes
        recv = recv.to(x.device)
    STATS["p2p_s"] += time.perf_counter() - t0
    return recv


def halo_exchange(tree, mesh):
    """The one communication of the region-decomposed GS step: every
    shard sends its whole payload (boundary states + actions) one hop
    around the block ring in both directions and receives its two
    neighbours'. Returns ``(prev, next)``, the payloads of blocks b-1
    and b+1 (mod n), as two ring shifts per leaf; nothing else (no
    all-reduce or gather) may appear in a sharded-GS body, which
    ``repro_torch.analysis.contracts.HaloOnly`` audits."""
    STATS["halo_exchanges"] += 1
    prev = tree_map(lambda x: ppermute_ring(x, mesh, shift=1), tree)
    nxt = tree_map(lambda x: ppermute_ring(x, mesh, shift=-1), tree)
    return prev, nxt
