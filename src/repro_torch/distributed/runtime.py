"""Sharded runtime substrate for the DIALS outer loop — the port of
``repro/distributed/runtime.py``.

What the agent-sharded Algorithm-1 round needs, factored out so tests
and benchmarks can use it without the runner:

* **the shard mesh** — :func:`shard_mesh` returns a :class:`ShardMesh`:
  this process's shard of a ``torch.distributed`` group, one shard per
  process (the reference's ``("shards",)`` device mesh has one shard per
  device and may span several devices of a process). A one-shard mesh
  with no group is legal, as the reference's one-device mesh is;
  :func:`choose_shards` picks the largest shard count that divides the
  agent count (the agent axis must tile exactly).
* **agent-axis placement** — every leaf of the IALS/AIP state has
  leading axis N: :func:`shard_agent_tree` slices this rank's block of
  N/S agents out of a full tree, :func:`fetch_tree` gathers the blocks
  back (an ``all_gather``: every rank ends up holding every agent).
* **the mesh after a host loss** — :func:`mesh_hosts`,
  :func:`mesh_spans_processes`, :func:`shards_on_hosts` and
  :func:`surviving_devices` say which processes a mesh spans and which
  shards a dead host orphans; :func:`survivor_mesh` is the mesh on which
  a survivor owns its agents alone (no group: its collectives are the
  identity, as on a one-shard mesh), since a survivor whose peer died
  still sits in the old group, which can no longer communicate;
* **the collective tables** — the c10d ops a recorded program may
  dispatch, by the names the port's op recorder gives them
  (``repro_torch.analysis.walker``: ``c10d.allreduce_``,
  ``_c10d_functional.all_reduce``, ...). :data:`COLLECTIVE_PRIMS` is
  every communicating op, :data:`HALO_PRIMS` the neighbour-only ones a
  region-decomposed GS body may contain; the contract rules
  (``repro_torch.analysis.contracts.CollectiveFree``/``HaloOnly``) read
  them, and :func:`validate_collective_tables` holds them to the ops
  the running torch registers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Set, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.tree import tree_map

SHARD_AXIS = "shards"

# Every communicating c10d op, as the op recorder names them (the
# dispatcher's "ns::op" with a dot). The process-group ops (``c10d.*``,
# what ``torch.distributed.all_reduce`` and its kind dispatch) and the
# functional collectives (``_c10d_functional.*``, what traced and
# compiled code dispatches).
COLLECTIVE_PRIMS: frozenset = frozenset({
    "c10d.allreduce_", "c10d.allreduce_coalesced_", "c10d.allgather_",
    "c10d._allgather_base_", "c10d.allgather_coalesced_",
    "c10d.allgather_into_tensor_coalesced_", "c10d.reduce_",
    "c10d.reduce_scatter_", "c10d._reduce_scatter_base_",
    "c10d.reduce_scatter_tensor_coalesced_", "c10d.broadcast_",
    "c10d.gather_", "c10d.scatter_", "c10d.alltoall_",
    "c10d.alltoall_base_", "c10d.barrier", "c10d.monitored_barrier_",
    "c10d.send", "c10d.recv_", "c10d.recv_any_source_",
    "_c10d_functional.all_reduce", "_c10d_functional.all_reduce_",
    "_c10d_functional.all_reduce_coalesced",
    "_c10d_functional.all_reduce_coalesced_",
    "_c10d_functional.all_gather_into_tensor",
    "_c10d_functional.all_gather_into_tensor_out",
    "_c10d_functional.all_gather_into_tensor_coalesced",
    "_c10d_functional.reduce_scatter_tensor",
    "_c10d_functional.reduce_scatter_tensor_out",
    "_c10d_functional.reduce_scatter_tensor_coalesced",
    "_c10d_functional.all_to_all_single", "_c10d_functional.broadcast",
    "_c10d_functional.broadcast_", "_c10d_functional.isend",
    "_c10d_functional.irecv", "_c10d_functional.batch_p2p_ops",
    "_c10d_functional_autograd.all_gather_into_tensor",
    "_c10d_functional_autograd.reduce_scatter_tensor",
    "_c10d_functional_autograd.all_to_all_single",
})

# Registered c10d ops that do not communicate (the reference leaves
# ``axis_index`` out of its table the same way). ``_wrap_tensor_autograd``
# (it wraps a tensor as an ``AsyncCollectiveTensor``) registers when
# ``torch.distributed._functional_collectives`` is imported, which
# ``torch.testing.assert_close`` does.
NON_COMMUNICATING: frozenset = frozenset({
    "c10d.check_for_nan", "_c10d_functional.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd",
})

# Neighbour-only communication: what a region-decomposed GS body may
# contain (``repro_torch.distributed.collectives.halo_exchange`` sends
# and receives one hop around the block ring). No reduction and no
# gather: anything else in a GS body means the decomposed rollout
# re-centralized.
HALO_PRIMS: frozenset = frozenset({
    "c10d.send", "c10d.recv_", "_c10d_functional.isend",
    "_c10d_functional.irecv", "_c10d_functional.batch_p2p_ops",
})


# ---------------------------------------------------------------------------
# the group and the mesh
# ---------------------------------------------------------------------------
def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Processes in this process's ``torch.distributed`` group (1 when
    there is none) — the port's count of shard devices."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def choose_shards(n_agents: int, n_devices: Optional[int] = None) -> int:
    """Largest divisor of ``n_agents`` that is ≤ the device count (by
    default the group's world size)."""
    if n_devices is None:
        n_devices = world_size()
    for s in range(min(n_agents, n_devices), 0, -1):
        if n_agents % s == 0:
            return s
    return 1


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This process's place on the 1-D shard mesh: ``rank`` of
    ``n_shards`` shards, its tensors on ``device``, its collectives on
    ``group`` (None on a one-shard mesh without a process group).
    ``hosts`` is the process id of each shard (None: shard i is process
    i, as on the group's own mesh)."""
    n_shards: int
    rank: int
    device: torch.device
    group: Any = None
    hosts: Optional[Tuple[int, ...]] = None

    @property
    def shard_hosts(self) -> Tuple[int, ...]:
        """The process id of each shard, in shard order."""
        return (tuple(self.hosts) if self.hosts is not None
                else tuple(range(self.n_shards)))

    def block(self, n_agents: int) -> slice:
        """The agent rows this shard owns: [rank·B, (rank+1)·B)."""
        if n_agents % self.n_shards:
            raise ValueError(
                f"{n_agents} agents cannot tile {self.n_shards} shards")
        b = n_agents // self.n_shards
        return slice(self.rank * b, (self.rank + 1) * b)


def shard_mesh(n_shards: Optional[int] = None, *,
               device="cuda") -> ShardMesh:
    """The shard mesh of this process's group: one shard per process,
    so ``n_shards`` (default: the world size) must equal the world size
    — the reference can leave devices idle, the port cannot leave a rank
    without a shard. Without a group only ``n_shards`` 1 is legal."""
    dev = resolve_device(device)
    world = world_size()
    if n_shards is None:
        n_shards = world
    if n_shards != world:
        raise ValueError(
            f"asked for {n_shards} shards on a group of {world} "
            f"process(es): the port runs exactly one shard per process "
            f"(start {n_shards} ranks through repro_torch.distributed."
            f"bootstrap)")
    dist = _dist()
    return ShardMesh(n_shards=n_shards, rank=process_rank(), device=dev,
                     group=dist.group.WORLD if dist is not None else None)


def mesh_hosts(mesh: ShardMesh) -> tuple:
    """Sorted process ids whose shards make up ``mesh``."""
    return tuple(sorted(set(mesh.shard_hosts)))


def mesh_spans_processes(mesh: ShardMesh) -> bool:
    return len(mesh_hosts(mesh)) > 1


def shards_on_hosts(mesh: ShardMesh, hosts: Iterable[int]) -> tuple:
    """Shard indices whose process is one of ``hosts``: the work units
    orphaned when those hosts die."""
    hosts = set(hosts)
    return tuple(i for i, h in enumerate(mesh.shard_hosts) if h in hosts)


def surviving_devices(mesh: ShardMesh, dead_hosts: Iterable[int]) -> list:
    """The surviving shards' processes, in shard order: ``mesh``'s shard
    slots minus the dead hosts' (a port shard is its process; the
    reference lists devices)."""
    dead = set(dead_hosts)
    return [h for h in mesh.shard_hosts if h not in dead]


def survivor_mesh(mesh: ShardMesh, dead_hosts: Iterable[int]) -> ShardMesh:
    """The mesh this process trains on after ``dead_hosts`` died: one
    shard, its own, with no group (every collective on it is the
    identity, so the survivor never calls into the old group again).

    Only one surviving process is supported in process: the old group
    cannot be shrunk without its dead members (a new group is a
    collective of the whole old group), so with more than one survivor
    this raises, and the survivors take the recovery path instead
    (``repro_torch.distributed.recovery``: re-bootstrap a shrunken group
    from the last committed checkpoint)."""
    survivors = surviving_devices(mesh, dead_hosts)
    me = mesh.shard_hosts[mesh.rank]
    if me not in survivors:
        raise ValueError(f"process {me} is among the dead {sorted(set(dead_hosts))}")
    if len(survivors) > 1:
        raise NotImplementedError(
            f"{len(survivors)} processes survive: in-process reassignment "
            f"onto a mesh of several surviving processes is not supported "
            f"by the port (the old group cannot shrink without its dead "
            f"members); recover by re-bootstrapping a shrunken group "
            f"(repro_torch.distributed.recovery.recover)")
    return ShardMesh(n_shards=1, rank=0, device=mesh.device, group=None,
                     hosts=(me,))


def spare_device(n_in_use: int):
    """Always None: every rank has one device and shards onto it (the
    reference's spare device for the overlapped collect has no
    counterpart)."""
    del n_in_use
    return None


# ---------------------------------------------------------------------------
# agent-axis placement
# ---------------------------------------------------------------------------
def shard_agent_tree(tree, mesh: ShardMesh):
    """This shard's block of an agent-stacked tree (every tensor leaf has
    leading axis N): leaves (N/S, ...) on the mesh's device, copies of
    the rows, not views. Non-tensor leaves pass through."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x[mesh.block(x.shape[0])].to(mesh.device).clone()
    return tree_map(one, tree)


def fetch_tree(tree, mesh: ShardMesh):
    """The full tree from every shard's block: leaves (N, ...) on every
    rank, the blocks in rank order (an all-gather; the identity on a
    one-shard mesh)."""
    from repro_torch.distributed import collectives
    return collectives.tree_all_gather(tree, mesh)


def local_slice_struct(tree, n_shards: int):
    """Shape and dtype of one shard's slice of an agent-stacked tree, as
    ``meta`` tensors: what the per-shard body sees."""
    def one(x):
        n = x.shape[0]
        if n % n_shards:
            raise ValueError(
                f"agent axis {n} not divisible by {n_shards} shards")
        return torch.empty((n // n_shards,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device="meta")
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# the collective tables against the running torch
# ---------------------------------------------------------------------------
def live_collective_prims() -> Set[str]:
    """The c10d ops the running torch registers, under the recorder's
    names, minus :data:`NON_COMMUNICATING`."""
    import torch.distributed  # noqa: F401  (registers the c10d ops)
    prefixes = ("c10d::", "_c10d_functional::",
                "_c10d_functional_autograd::")
    live = {name.replace("::", ".")
            for name in torch._C._dispatch_get_all_op_names()
            if name.startswith(prefixes)}
    return live - NON_COMMUNICATING


def validate_collective_tables() -> None:
    """Raise if the frozen tables rotted against the running torch:
    every live c10d op must be classified (else an upgrade could add a
    collective the audits silently wave through), and the halo
    whitelist must stay a subset of the collective set."""
    missing = live_collective_prims() - COLLECTIVE_PRIMS
    if missing:
        raise AssertionError(
            f"COLLECTIVE_PRIMS is missing live c10d ops {sorted(missing)} "
            f"— the no-collectives audit would not see them; add them to "
            f"the table (or to NON_COMMUNICATING)")
    if not HALO_PRIMS <= COLLECTIVE_PRIMS:
        raise AssertionError(
            f"HALO_PRIMS {sorted(HALO_PRIMS - COLLECTIVE_PRIMS)} not in "
            f"COLLECTIVE_PRIMS — the halo whitelist must be a subset of "
            f"the collective set")
