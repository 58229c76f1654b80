"""The port's host-loss pieces of ``repro_torch.distributed.fault`` and
``runtime`` against the reference (``repro.distributed.fault``): the
straggler and elastic plans equal field by field over a grid, their
``elastic_reassign`` events included; a JAX ``HostMonitor`` and a port
``HostMonitor`` see each other's beats in one directory; death is sticky;
the survivor's mesh and the reshard of the mirror onto it."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.distributed import fault as jfault
from repro_torch.distributed import fault, runtime


class _Rec:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})


def _dead_sets(n):
    return [d for k in range(n) for d in itertools.combinations(range(n), k)]


@pytest.mark.parametrize("n_agents", [4, 6, 8, 12, 100])
def test_elastic_plan_grid_matches_reference(n_agents):
    for n_shards in [s for s in range(1, 9) if n_agents % s == 0]:
        for dead in _dead_sets(n_shards)[:40]:
            a, b = _Rec(), _Rec()
            got = fault.elastic_plan(n_agents, n_shards, dead, telemetry=a)
            want = jfault.elastic_plan(n_agents, n_shards, dead,
                                       telemetry=b)
            assert (got.old_shards, got.new_shards, got.dead,
                    got.survivors) == (want.old_shards, want.new_shards,
                                       want.dead, want.survivors)
            assert [got.owner(k) for k in range(n_shards)] == \
                [want.owner(k) for k in range(n_shards)]
            assert [got.agent_owner(k) for k in range(n_agents)] == \
                [want.agent_owner(k) for k in range(n_agents)]
            assert got.reassigned_blocks == want.reassigned_blocks
            assert a.events == b.events
    with pytest.raises(RuntimeError, match="all shards dead"):
        fault.elastic_plan(4, 2, [0, 1])
    with pytest.raises(ValueError, match="outside"):
        fault.elastic_plan(4, 2, [2])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_straggler_plan_grid_matches_reference(n_shards):
    for late in _dead_sets(n_shards):
        got = fault.straggler_plan(n_shards, late)
        want = jfault.straggler_plan(n_shards, late)
        assert (got.reassign, got.healthy) == (want.reassign, want.healthy)
        assert [got.owner(k) for k in range(n_shards)] == \
            [want.owner(k) for k in range(n_shards)]
    with pytest.raises(RuntimeError, match="all shards late"):
        fault.straggler_plan(2, [0, 1])


def test_host_monitors_see_each_others_beats(tmp_path):
    """The beat files are the reference's: a JAX monitor (host 0) and a
    port monitor (host 1) gate each other; death is sticky on both."""
    d = str(tmp_path)
    rec_j, rec_t = _Rec(), _Rec()
    jm = jfault.HostMonitor(d, host=0, n_hosts=2, timeout_s=0.3,
                            poll_s=0.01, telemetry=rec_j)
    tm = fault.HostMonitor(d, host=1, n_hosts=2, timeout_s=0.3,
                           poll_s=0.01, telemetry=rec_t)
    tm.beat(0)
    assert jm.gate(0) == ()
    assert tm.gate(0) == ()              # the JAX monitor beat round 0
    assert tm.last_wait_s < 0.3
    assert tm.gate(1) == (0,)            # host 0 silent for round 1
    assert tm.dead == {0} and tm.last_wait_s >= 0.3
    assert tm.gate(2) == ()              # sticky: not waited on again
    assert tm.last_wait_s < 0.3
    jm.beat(1)
    assert jm.gate(2) == ()              # the port beat round 2
    assert jm.gate(3) == (1,)
    assert [(e["event"], e["round"], e["dead_hosts"], e["all_dead"])
            for e in rec_t.events] == [("host_death", 1, [0], [0])]
    assert [(e["event"], e["round"], e["dead_hosts"])
            for e in rec_j.events] == [("host_death", 3, [1])]


def test_survivor_mesh_and_reshard_agents():
    dev = torch.device("cpu")
    mesh = runtime.ShardMesh(n_shards=4, rank=2, device=dev)
    assert runtime.mesh_hosts(mesh) == (0, 1, 2, 3)
    assert runtime.mesh_spans_processes(mesh)
    assert runtime.shards_on_hosts(mesh, [1, 3]) == (1, 3)
    assert runtime.surviving_devices(mesh, [1, 3]) == [0, 2]
    with pytest.raises(NotImplementedError, match="recovery"):
        runtime.survivor_mesh(mesh, [1, 3])
    with pytest.raises(ValueError, match="among the dead"):
        runtime.survivor_mesh(mesh, [0, 1, 2])
    solo = runtime.survivor_mesh(mesh, [0, 1, 3])
    assert (solo.n_shards, solo.rank, solo.group, solo.shard_hosts) == \
        (1, 0, None, (2,))
    assert not runtime.mesh_spans_processes(solo)
    assert runtime.shards_on_hosts(solo, [0, 1, 3]) == ()
    mirror = {"w": torch.arange(24.0).reshape(8, 3),
              "r": torch.arange(8)}
    placed = fault.reshard_agents(mirror, solo)
    assert torch.equal(placed["w"], mirror["w"])
    assert placed["w"].data_ptr() != mirror["w"].data_ptr()
    half = fault.reshard_agents(mirror, runtime.ShardMesh(
        n_shards=2, rank=1, device=dev))
    np.testing.assert_array_equal(half["r"].numpy(), np.arange(4, 8))
    plan = fault.elastic_plan(8, 4, runtime.shards_on_hosts(mesh,
                                                            [0, 1, 3]))
    assert plan.new_shards == solo.n_shards
