"""Logical-axis -> mesh-axis sharding rules (MaxText-style) — the port of
``repro/distributed/mesh.py``.

Model code annotates parameters with *logical* axis names
(``("embed", "mlp")``); this module resolves them against a rule table
for a mesh, with the reference's two production details:

* **divisibility fallback** — a logical axis only binds to a mesh axis if
  the dimension size divides the axis size; otherwise it falls back to a
  prefix of the target axes (or replication). E.g. ``kv_heads=8`` cannot
  shard over ``model=16`` as a cache dimension, but the *flattened*
  projection dim (kv_heads·head_dim) can.
* **FSDP residual sharding** — after rule application, parameters are
  additionally sharded over the (pod, data) axes on their largest free
  dimension (ZeRO-3 style), so per-device parameter + optimizer memory
  scales down with the full mesh, not just the model axis.

A spec is the port's own tuple, one entry per tensor dim: ``None``, a
mesh-axis name, or a tuple of names (major first), element for element
the reference's ``PartitionSpec``. Resolution reads only the mesh's axis
sizes, so it runs on an :class:`AbstractMesh` (names and sizes, no
devices) as well as on a ``torch.distributed.device_mesh.DeviceMesh``.
:class:`NamedSharding` pairs a mesh with a spec; on a ``DeviceMesh`` it
turns into DTensor placements (:func:`to_placements`) and places a tensor
(:func:`distribute`). A dim split over several mesh axes is split in the
spec's order: where that order is not the mesh's (``("model", "data")``
in ``launch.variants.DECODE_TP2D_RULES``), the outer mesh dim takes a
``_StridedShard`` so the rank at (data=d, model=m) holds block
``m * |data| + d``, as a JAX mesh lays it out.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import torch

Rules = Tuple[Tuple[str, Union[str, Tuple[str, ...], None]], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Training-time rules. Order matters: first applicable rule wins.
TRAIN_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),
    ("embed", None),
    ("layers", None),
    ("seq", None),
    ("cache_batch", ("pod", "data")),
    ("cache_seq", None),
)

# Decode rules (decode_32k). KV caches are the dominant bytes: batch over
# (pod, data); the cache sequence axis takes the model axis (kv_heads are
# usually 4–8 and cannot split 16 ways — the divisibility fallback then
# leaves "model" free, so cache_seq claims it and attention reduces over
# the sharded key axis with small all-reduces).
DECODE_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("cache_batch", ("pod", "data")),
    ("cache_seq", "model"),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),
    ("embed", None),
    ("layers", None),
    ("seq", None),
)

# long_500k (global_batch=1): the KV/attention cache sequence axis is the
# only large axis — shard it over `data`.
LONG_CONTEXT_RULES: Rules = (
    ("batch", None),
    ("cache_batch", None),
    ("cache_seq", "data"),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("expert", "model"),
    ("embed", None),
    ("layers", None),
    ("seq", None),
)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices: what spec resolution and the
    dry-run's shard shapes read."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.names, self.sizes))


def mesh_shape(mesh) -> "OrderedDict[str, int]":
    """Axis name -> size, in mesh order, of an :class:`AbstractMesh`, a
    named ``DeviceMesh`` or a plain mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return OrderedDict(zip(mesh.mesh_dim_names, mesh.shape))
    return OrderedDict(mesh.shape if hasattr(mesh, "shape") else mesh)


def _axis_size(shape, axes: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(shape[a] for a in axes)


def resolve_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Rules) -> Spec:
    """Map one logical-axis tuple to a spec, respecting divisibility and
    never using a mesh axis twice."""
    mshape = mesh_shape(mesh)
    used: set = set()
    out = []
    rule_map = {}
    for name, target in rules:
        rule_map.setdefault(name, target)
    for dim, name in zip(shape, logical):
        target = rule_map.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        taxes = (target,) if isinstance(target, str) else tuple(target)
        taxes = tuple(a for a in taxes if a in mshape and a not in used)
        if not taxes or dim % _axis_size(mshape, taxes) != 0:
            # try single-axis prefixes before giving up
            ok = None
            for k in range(len(taxes), 0, -1):
                sub = taxes[:k]
                if sub and dim % _axis_size(mshape, sub) == 0:
                    ok = sub
                    break
            taxes = ok or ()
        if taxes:
            used.update(taxes)
            out.append(taxes if len(taxes) > 1 else taxes[0])
        else:
            out.append(None)
    return tuple(out)


def _fsdp_augment(spec: Spec, shape: Sequence[int], mesh,
                  fsdp_axes: Tuple[str, ...]) -> Spec:
    """Shard the largest unsharded dim over the unused fsdp axes."""
    mshape = mesh_shape(mesh)
    used = set()
    for s in spec:
        if s is None:
            continue
        used.update((s,) if isinstance(s, str) else s)
    free = tuple(a for a in fsdp_axes if a in mshape and a not in used)
    if not free:
        return spec
    size = _axis_size(mshape, free)
    # largest dim, prefer trailing, must divide
    best, best_dim = None, 0
    for i, (dim, s) in enumerate(zip(shape, spec)):
        if s is None and dim % size == 0 and dim >= best_dim and dim >= size:
            best, best_dim = i, dim
    if best is None:
        return spec
    new = list(spec)
    new[best] = free if len(free) > 1 else free[0]
    return tuple(new)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of ``spec`` on a named
    ``DeviceMesh``: ``Shard(d)`` where mesh axis n splits tensor dim d,
    else ``Replicate()``. A dim split over two mesh axes out of mesh
    order gets ``_StridedShard`` on the outer mesh dim (see the module
    docstring); any other out-of-order split is refused (no rule table
    makes one)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        order = [names.index(a) for a in axes]
        if order == sorted(order):
            for i in order:
                out[i] = Shard(dim)
        elif len(order) == 2:
            major, minor = order            # major is the inner mesh dim
            out[major] = Shard(dim)
            out[minor] = _StridedShard(dim, split_factor=mesh_shape(mesh)[
                names[major]])
        else:
            raise ValueError(f"spec entry {entry!r}: a split over more than "
                             f"two mesh axes must follow the mesh order "
                             f"{tuple(names)}")
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """The local shape of one device's shard (every split divides)."""
    mshape = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            size = _axis_size(mshape, axes)
            assert out[dim] % size == 0, (shape, spec)
            out[dim] //= size
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(self.spec, shape, self.mesh)

    def padded(self, ndim: int) -> "NamedSharding":
        """The spec padded with ``None`` to ``ndim`` entries."""
        return NamedSharding(self.mesh, tuple(self.spec)
                             + (None,) * (ndim - len(self.spec)))


def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_specs(fn, spec_tree, *trees):
    """``fn(logical, *leaves)`` over a logical-spec tree (leaves are
    tuples of axis names or ``()``) and trees parallel to it (lists and
    dicts; a ``None`` subtree maps to ``None``)."""
    if spec_tree is None:
        return None
    if is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees))
                for k in spec_tree}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(
            map_specs(fn, s, *(t[i] for t in trees))
            for i, s in enumerate(spec_tree))
    raise TypeError(f"not a logical-spec tree node: {spec_tree!r}")


def stack_specs(tree):
    """Prepend the stacked-repeats ("layers") axis to every leaf."""
    return map_specs(lambda ax: ("layers",) + tuple(ax), tree)


def logical_to_sharding(spec_tree, shape_tree, mesh, *,
                        rules: Rules = TRAIN_RULES,
                        fsdp_axes: Tuple[str, ...] = ()):
    """Resolve a logical-spec tree (parallel to a params/cache tree whose
    leaves have a ``.shape``: tensors, meta tensors) into
    :class:`NamedSharding` leaves."""
    def one(logical, leaf):
        shape = tuple(leaf.shape)
        logical = tuple(logical)
        if len(logical) < len(shape):          # scalar/under-specified
            logical = logical + (None,) * (len(shape) - len(logical))
        spec = resolve_spec(logical[:len(shape)], shape, mesh, rules)
        if fsdp_axes:
            spec = _fsdp_augment(spec, shape, mesh, fsdp_axes)
        return NamedSharding(mesh, spec)

    return map_specs(one, spec_tree, shape_tree)


def batch_spec(mesh, *, long_context: bool = False) -> Spec:
    if long_context:
        return (None,)
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return (axes if len(axes) > 1 else axes[0],)


def batch_sharding(mesh, **kw) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh, **kw))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# Placing tensors (DTensor)
# ---------------------------------------------------------------------------
def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank, on the mesh's device) as
    a DTensor laid out by ``sharding``: each rank keeps its own block,
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    sh = sharding.padded(x.ndim)
    return distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)


def constrain(x, sharding: NamedSharding):
    """The port of ``with_sharding_constraint``: redistribute a DTensor to
    ``sharding`` (a plain tensor is distributed as a replica first)."""
    from torch.distributed.tensor import DTensor, Replicate
    sh = sharding.padded(x.ndim)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sh.mesh, [Replicate()] * sh.mesh.ndim,
                               run_check=False)
    return x.redistribute(sh.mesh, sh.placements)


# ---------------------------------------------------------------------------
# Local regions: ops with no DTensor sharding rule run on each rank's
# block, on inputs redistributed to what the op needs
# ---------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shape_like(local, like, placements):
    """A DTensor over ``like``'s mesh holding ``local`` as this rank's
    block under ``placements`` (the global shape follows from them)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = like.device_mesh
    shape = list(local.shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            shape[pl.dim] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def batch_placements(x) -> tuple:
    """``x``'s placements with every split of a dim other than the
    leading (batch) dim undone."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def block_offset(x, dim: int) -> int:
    """Where this rank's block of DTensor ``x`` starts along ``dim``: the
    mesh dims splitting ``dim`` nest in mesh order, or, with a
    ``_StridedShard`` (:func:`to_placements`), the inner one major. No
    tensor is made (it works on fake tensors)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, (Shard, _StridedShard)) and p.dim == dim]
    if any(isinstance(x.placements[i], _StridedShard) for i in split):
        split = split[::-1]
    block, n = 0, 1
    for i in split:
        block = block * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return block * (x.shape[dim] // n)


def gather_rows(x):
    """``x`` with any split of a dim between the batch (first) and the
    features (last) undone — the sequence-parallel split; the batch and
    feature splits and partial sums are left as they are."""
    from torch.distributed.tensor import Shard
    last = x.ndim - 1
    if any(isinstance(p, Shard) and 0 < p.dim < last for p in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            _replicate() if isinstance(p, Shard) and 0 < p.dim < last else p
            for p in x.placements))
    return x


def unshard(tree, like):
    """FSDP's gather before use: every DTensor leaf of ``tree`` with a
    split on a mesh dim that splits ``like``'s batch (dim 0) is gathered
    along that mesh dim; its tensor-parallel splits stay. Under autograd
    the gradient comes back reduce-scattered to the leaf's layout."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(like):
        return tree
    batch = {i for i, p in enumerate(like.placements)
             if isinstance(p, Shard) and p.dim == 0}
    if not batch:
        return tree

    def one(w):
        if not is_dtensor(w) or not any(
                isinstance(w.placements[i], Shard) for i in batch):
            return w
        return w.redistribute(w.device_mesh, tuple(
            _replicate() if i in batch and isinstance(p, Shard) else p
            for i, p in enumerate(w.placements)))

    from repro_torch.tree import tree_map
    return tree_map(one, tree)


class _RowsGrad(torch.autograd.Function):
    """Identity forward; the gradient comes back with :func:`gather_rows`
    applied (see :func:`rows_grad`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g)


class _ReducedGrad(torch.autograd.Function):
    """Identity forward; the gradient comes back with its partial sums
    reduced (see :func:`reduced_grad`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g) if is_dtensor(g) else g


def partial_sum(local, like, placements):
    """The sum over the ranks' ``local`` blocks laid out as ``placements``
    (``Partial`` on the mesh dims they are summed over): a DTensor with
    those sums reduced, whose gradient reaches every block whole (a
    partial gradient from a later product is reduced first, so no rank
    gets only its share of it)."""
    y = reduce_partial(shape_like(local, like, placements))
    return _ReducedGrad.apply(y) if y.requires_grad else y


def rows_grad(x):
    """``x`` whose gradient arrives with no sequence split: a product's
    output, whose gradient otherwise takes the layout of the
    sequence-parallel carry it is added to, and a product's backward
    would then flatten (batch, sequence) splits into one strided split."""
    return _RowsGrad.apply(x) if x.requires_grad else x


def reduce_partial(x):
    """``x`` with its partial placements reduced (an all-reduce each)."""
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            _replicate() if p.is_partial() else p for p in x.placements))
    return x


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def replicate_tree(tree, like):
    """Every DTensor leaf gathered whole on every rank, as a plain tensor:
    the weights of a layer that runs per rank on the batch rows of
    ``like`` (an all-gather of each split). Under autograd each rank's
    rows add their share to the gradient, which is reduced back to the
    leaf's layout."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.tree import tree_map
    grads = tuple(Partial() if isinstance(p, Shard) and p.dim == 0
                  else _replicate() for p in like.placements)

    def one(w):
        if not is_dtensor(w):
            return w
        return w.redistribute(w.device_mesh,
                              [_replicate()] * w.device_mesh.ndim) \
            .to_local(grad_placements=grads)
    return tree_map(one, tree)


def replicated_scalar(value, like):
    """A 0-d tensor (the same on every rank) as a replicated DTensor on
    ``like``'s mesh."""
    return shape_like(value, like, (_replicate(),) * like.device_mesh.ndim)


def assign(dst, src) -> None:
    """``dst.copy_(src)``, ``src`` first laid out as ``dst`` (DTensors)."""
    if is_dtensor(dst) and is_dtensor(src):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def local_rows(fn, *xs):
    """``fn`` on each rank's batch rows: every DTensor input is
    redistributed to its batch split alone (an all-gather of any other
    split), ``fn`` runs on the local blocks, and each output comes back
    as a DTensor split over the batch as the first input is. Exact for
    any ``fn`` that treats batch rows independently."""
    like = next(x for x in xs if is_dtensor(x))
    place = batch_placements(like)
    mesh = like.device_mesh
    local = [x.redistribute(mesh, place).to_local() if is_dtensor(x) else x
             for x in xs]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(shape_like(o, like, place) for o in out)
    return shape_like(out, like, place)


def head_parallel(fn, q, k, v, *, heads: int, kv_heads: int):
    """``fn(q, k, v, kv_lo)`` on each rank's batch rows and attention
    heads. q is (B, T, heads·dh), k and v (B, T, kv_heads·dh), DTensors.
    The batch keeps the mesh dims it is split over; every other mesh dim
    splits the heads where they divide (the sequence is gathered), else
    replicates them. Where the query heads split and the kv heads cannot,
    the kv heads stay whole and ``kv_lo`` (the first kv head of this
    rank's query heads' groups) tells ``fn`` which to read. Attention is
    independent per (row, head), so the result is exact. Returns a DTensor
    (B, T, heads·dh) split as the query is."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    groups = heads // kv_heads
    qp, kp = [], []
    q_split = kv_split = 1
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            qp.append(p)
            kp.append(p)
            continue
        q_local = heads // (q_split * n) if heads % (q_split * n) == 0 \
            else 0
        kv_ok = kv_heads % (kv_split * n) == 0
        if q_local and (kv_ok or q_local % groups == 0
                        or groups % q_local == 0):
            qp.append(Shard(2))
            q_split *= n
            if kv_ok:
                kp.append(Shard(2))
                kv_split *= n
            else:
                kp.append(Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    # this rank's first query head: the head blocks nest in mesh order
    coord = mesh.get_coordinate()
    block = 0
    for i, p in enumerate(qp):
        if isinstance(p, Shard) and p.dim == 2:
            block = block * mesh.size(i) + coord[i]
    h0 = block * (heads // q_split)
    kv_block = 0
    for i, p in enumerate(kp):
        if isinstance(p, Shard) and p.dim == 2:
            kv_block = kv_block * mesh.size(i) + coord[i]
    kv_lo = h0 // groups - kv_block * (kv_heads // kv_split)
    out = fn(q.redistribute(mesh, qp).to_local(),
             k.redistribute(mesh, kp).to_local(),
             v.redistribute(mesh, kp).to_local(), kv_lo)
    return shape_like(out, q, tuple(qp))


def take_last(x, idx):
    """``x[..., idx]`` (the gold logit of each row): ``x`` a DTensor
    (..., V) whose last dim may be split, ``idx`` (...) integer. Each rank
    reads the entries of its own block of V (zero elsewhere) and the
    entries are summed over the mesh dims that split V (one rank holds
    each), so no rank gathers the (..., V) rows (the vocab-parallel cross
    entropy)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    rows = tuple(Replicate() if s else p
                 for s, p in zip(split, x.placements))
    if is_dtensor(idx):
        idx = idx.redistribute(mesh, rows).to_local()
    local = x.to_local()
    rel = idx.long() - block_offset(x, last)
    inside = (rel >= 0) & (rel < local.shape[-1])
    got = torch.gather(local, -1, rel.clamp(0, local.shape[-1] - 1)[..., None])
    got = torch.where(inside, got[..., 0], torch.zeros((), dtype=got.dtype,
                                                       device=got.device))
    out = tuple(Partial() if s else p for s, p in zip(split, x.placements))
    return partial_sum(got, x, out)


def lookup_rows(table, ids):
    """``table[ids]`` (an embedding lookup): ``table`` a DTensor whose
    rows (the vocab) may be split, its columns whole; ``ids`` integer.
    Each rank reads the rows of its own block (zero for the others),
    summed over the mesh dims that split the rows, laid out over the
    batch as ``ids`` is. (DTensor's own lookup leaves a masked partial
    whose backward it cannot take from a partial gradient.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    split = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    place = []
    for s_, p in zip(split, ids.placements if is_dtensor(ids) else
                     [Replicate()] * mesh.ndim):
        place.append(Replicate() if s_ or not isinstance(p, Shard)
                     or p.dim != 0 else p)
    # each rank's rows of the batch add their share to the table's
    # gradient: partial over the mesh dims that split the batch
    local = table.to_local(grad_placements=tuple(
        Partial() if isinstance(q, Shard) and not s_ else p
        for s_, p, q in zip(split, table.placements, place)))
    if is_dtensor(ids):
        ids = ids.redistribute(mesh, place).to_local()
    rel = ids.long() - block_offset(table, 0)
    inside = (rel >= 0) & (rel < local.shape[0])
    got = torch.nn.functional.embedding(rel.clamp(0, local.shape[0] - 1),
                                        local)
    got = got * inside[..., None].to(got.dtype)
    out = tuple(Partial() if s_ else p for s_, p in zip(split, place))
    return partial_sum(got, table, out)


def whole(x):
    """A small DTensor (an index vector) as the whole plain tensor on
    every rank."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def write_slot(dst, slot: int, value, dim: int = 1) -> None:
    """``dst[(:,)*dim slot] = value`` in place, ``value`` having size 1
    on ``dim``; for a DTensor ``dst`` only the rank whose block holds
    ``slot`` writes (``value`` is first laid out as ``dst`` with ``dim``
    whole)."""
    if not is_dtensor(dst):
        dst.narrow(dim, slot, 1).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    place = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                  else p for p in dst.placements)
    if is_dtensor(value):
        value = value.redistribute(mesh, place).to_local()
    local = dst.to_local()
    lo = block_offset(dst, dim)
    if lo <= slot < lo + local.shape[dim]:
        local.narrow(dim, slot - lo, 1).copy_(value)


# ---------------------------------------------------------------------------
# gloo on CUDA tensors: the functional collectives staged through the host
# ---------------------------------------------------------------------------
# On an H100 with torch 2.11 a functional all-gather of CUDA tensors over
# gloo (what DTensor's redistributions issue) kills the process in its
# wait (SIGSEGV); the same collective of CPU tensors runs. The ranks of
# one card share a gloo group (NCCL refuses two ranks on one GPU), so
# their DTensor collectives run under :func:`host_staged_collectives`.
_COLLECTIVES = frozenset({
    "all_gather_into_tensor", "all_gather_into_tensor_out",
    "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced", "all_reduce", "all_reduce_",
    "all_reduce_coalesced", "all_reduce_coalesced_", "all_to_all_single",
    "broadcast", "broadcast_"})
STAGED = {"_c10d_functional": _COLLECTIVES,
          "_c10d_functional_autograd": _COLLECTIVES,
          "_dtensor": frozenset({"shard_dim_alltoall"})}
STAGE_STATS = {"collectives": 0, "bytes": 0}


def _alltoall_by_gather(x, gather_dim: int, shard_dim: int, group_name):
    """DTensor's Shard(gather_dim) -> Shard(shard_dim) move of one block,
    as DTensor itself runs it on a CPU mesh: gather the blocks along
    ``gather_dim``, keep this rank's chunk along ``shard_dim``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.chunk(torch.cat(parts, dim=gather_dim), len(parts),
                       dim=shard_dim)[dist.get_rank(group)].contiguous()


def host_staged_collectives(device_type: str = "cuda"):
    """A dispatch mode under which every functional collective (and
    DTensor's ``shard_dim_alltoall``) of ``device_type`` tensors runs on
    host copies of them, synchronously, its result copied back to their
    device (a wait on such a result is then a no-op); nothing else leaves
    the device. :data:`STAGE_STATS` counts the collectives and the bytes
    staged each way."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map as pt_map

    def host(t):
        # contiguous: a backward's blocks are often transposed views,
        # which the collectives would read in storage order
        return t.contiguous().cpu() if isinstance(t, torch.Tensor) \
            and t.device.type == device_type else t

    staged = set()              # ids of the results this mode made

    def forget(key):
        staged.discard(key)

    def on_device(t, dev):
        out = t.to(dev)
        staged.add(id(out))
        weakref.finalize(out, forget, id(out))
        return out

    class _Staged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, DTensor) for t in types):
                # DTensor runs the op, its collectives under this mode
                return NotImplemented
            kwargs = kwargs or {}
            names = STAGED.get(func.namespace, ())
            name = func.__name__.split(".")[0]
            if func.namespace == "_c10d_functional" \
                    and name == "wait_tensor" and id(args[0]) in staged:
                return args[0]       # its collective ran, staged, in full
            dev = next((a.device for a in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)
                and a.device.type == device_type), None)
            if name not in names or dev is None:
                return func(*args, **kwargs)
            if name == "shard_dim_alltoall":
                out = _alltoall_by_gather(*pt_map(host, args))
            else:
                out = pt_map(
                    lambda t: torch.ops._c10d_functional.wait_tensor(t)
                    if isinstance(t, torch.Tensor) else t,
                    func(*pt_map(host, args), **pt_map(host, kwargs)))
            if name.endswith("_"):   # in place: the inputs take the result
                for dst, src in zip(torch.utils._pytree.tree_leaves(args[0]),
                                    torch.utils._pytree.tree_leaves(out)):
                    dst.copy_(src)
                out = args[0]
            else:
                out = pt_map(lambda t: on_device(t, dev)
                             if isinstance(t, torch.Tensor) else t, out)
            STAGE_STATS["collectives"] += 1
            STAGE_STATS["bytes"] += sum(
                t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves((args, out))
                if isinstance(t, torch.Tensor))
            return out

    return _Staged()
