"""The port's distributed checkpoints (``repro_torch.checkpoint.
distributed``) against the reference's (``repro.checkpoint.distributed``)
on the CPU: the same files for the same state, leaf by leaf, on one shard
(every leaf in ``replicated/``) and on two (one agent slice per rank);
steps written by either package restore exactly in the other, into one
and two shards and through the flat managers; and the reference's cases
(``tests/test_checkpoint.py``): an incomplete prepare, a corrupted slice,
the GC of uncommitted steps, the ``finalize_pending`` takeover."""
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal
from repro.checkpoint import distributed as jdckpt
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import dials as jdials
from repro.core import influence as jinf
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro_torch import convert
from repro_torch.checkpoint import distributed as dckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import chaos, runtime
from repro_torch.tree import leaves, tree_map

ENV = dict(side=2, horizon=16)
POLICY = dict(kind="gru", hidden=(16,), gru_hidden=8)
AIP = dict(kind="gru", hidden=(16,), gru_hidden=8, epochs=3, batch=4)
DIALS = dict(aip_refresh=2, collect_envs=4, collect_steps=16, n_envs=4,
             rollout_steps=8, eval_episodes=2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def states():
    """A reference trainer's state (numpy leaves, the AIPs perturbed so
    no leaf is all zeros), its struct, and the same state in the port."""
    jmod, jcfg = jreg.make("warehouse", **ENV)
    info = jcfg.info()
    jtr = jdials.DIALSTrainer(
        jmod, jcfg, jpol.PolicyConfig(info.obs_dim, info.n_actions,
                                      use_kernels="off", **POLICY),
        jinf.AIPConfig(info.alsh_dim, info.n_influence, use_kernels="off",
                       **AIP),
        jppo.PPOConfig(use_kernels="off", epochs=1, minibatches=2),
        jdials.DIALSConfig(shards=1, use_kernels="off", outer_rounds=1,
                           **DIALS))
    # init compiled as one program (called as is, each op compiles on
    # its own); ``round`` is set below
    jstate = jax.tree.map(np.asarray,
                          jax.jit(jtr.init)(jax.random.PRNGKey(3)))
    jstate["round"] = 2
    rng = np.random.RandomState(0)
    jstate["aips"] = jax.tree.map(
        lambda x: x + rng.randn(*x.shape).astype(x.dtype)
        if x.dtype.kind == "f" else x, jstate["aips"])
    return jstate, jtr._state_struct(jstate), convert.from_jax_state(
        jstate, device="cpu")


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _manifest_leaves(path):
    m = dckpt.ckpt.load_manifest(path)
    return [(e["name"], e["shape"]) for e in m["leaves"]]


def _jax_slices(d, jstate, n, step, extra):
    """The reference's two-slice step (its manager's layout on a 2-shard
    mesh) from host arrays: the agent leaves by row range, round and key
    replicated."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"aips": jstate["aips"], "ials": jstate["ials"]})
    named = {jdckpt.ckpt.leaf_name(p): x for p, x in flat}
    for lo, hi in ((0, n // 2), (n // 2, n)):
        jdckpt.write_slice(d, {k: v[lo:hi] for k, v in named.items()},
                           lo, hi, n, step=step)
    jdckpt.write_replicated(d, {"round": jstate["round"],
                                "key": jstate["key"]}, step=step,
                            extra=extra)
    jdckpt.write_commit(d, jdckpt.build_commit_meta(d))


def _port_two_ranks(directory, state, step, extra, keep=5):
    """Both ranks of a 2-shard save, in one process: rank 0 commits on
    its writer thread once rank 1's slice is down."""
    mgrs = [dckpt.DistributedCheckpointManager(
        directory, process_id=r, keep=keep, async_write=(r == 0))
        for r in range(2)]
    for r, mgr in enumerate(mgrs):
        mesh = runtime.ShardMesh(n_shards=2, rank=r, device=CPU)
        mgr.save(step, {**state, **runtime.shard_agent_tree(
            {"aips": state["aips"], "ials": state["ials"]}, mesh)},
            extra=extra, mesh=mesh)
    for mgr in mgrs:
        mgr.wait()


def _zeros(tree):
    return tree_map(lambda x: torch.zeros_like(x) if torch.is_tensor(x)
                    else 0, tree)


def _agents(tree):
    return {"aips": tree["aips"], "ials": tree["ials"]}


def test_same_files_as_the_reference(tmp_path, states):
    jstate, _, state = states
    n = len(jax.tree.leaves(jstate["aips"])[0])
    extra = {"async_round": None, "reports": [1] * n}
    # one shard: the reference's manager on one device, every leaf in
    # replicated/
    jdckpt.DistributedCheckpointManager(
        str(tmp_path / "j1"), async_write=False).save(2, jstate,
                                                      extra=extra)
    dckpt.DistributedCheckpointManager(
        str(tmp_path / "t1"), async_write=False).save(2, state, extra=extra)
    j1, t1 = str(tmp_path / "j1" / "step_2"), str(tmp_path / "t1" / "step_2")
    assert _files(j1) == _files(t1)
    assert _files(t1)[0] == "COMMIT" and not dckpt.slice_dirs(t1)
    assert _manifest_leaves(os.path.join(j1, "replicated")) == \
        _manifest_leaves(os.path.join(t1, "replicated"))
    assert dckpt.committed_meta(t1) == jdckpt.committed_meta(j1)
    # two shards: one slice per rank
    _jax_slices(str(tmp_path / "j2" / "step_2"), jstate, n, 2, extra)
    _port_two_ranks(str(tmp_path / "t2"), state, 2, extra)
    j2, t2 = str(tmp_path / "j2" / "step_2"), str(tmp_path / "t2" / "step_2")
    assert _files(j2) == _files(t2)
    for lo, hi, path in dckpt.slice_dirs(t2):
        assert _manifest_leaves(path) == _manifest_leaves(
            os.path.join(j2, os.path.basename(path)))
    assert jdckpt.committed_meta(t2) == jdckpt.committed_meta(j2)


def test_reference_steps_restore_in_the_port(tmp_path, states):
    jstate, _, state = states
    n = len(jax.tree.leaves(jstate["aips"])[0])
    extra = {"async_round": 1, "reports": list(range(n))}
    _jax_slices(str(tmp_path / "step_2"), jstate, n, 2, extra)
    jdckpt.DistributedCheckpointManager(
        str(tmp_path / "one"), async_write=False).save(2, jstate,
                                                       extra=extra)
    target = _zeros(state)
    for directory in (str(tmp_path), str(tmp_path / "one")):
        mgr = dckpt.DistributedCheckpointManager(directory)
        tree, step = mgr.restore_latest(target)
        assert step == 2 and tree["round"] == 2
        assert mgr.last_extra == extra
        assert_tree_equal(convert.to_numpy(_agents(tree)), _agents(jstate))
        assert_tree_equal(convert.to_numpy(tree["key"]), jstate["key"])
        for a, t in zip(leaves(tree), leaves(target)):
            assert getattr(a, "dtype", int) == getattr(t, "dtype", int)
        # one shard, then each of two: the block's rows
        for shards in (1, 2):
            for rank in range(shards):
                mesh = runtime.ShardMesh(n_shards=shards, rank=rank,
                                         device=CPU)
                block, _ = mgr.restore_latest(target, mesh=mesh)
                want = runtime.shard_agent_tree(_agents(tree), mesh)
                assert all(torch.equal(a, b) for a, b in zip(
                    leaves(_agents(block)), leaves(want)))
                assert torch.equal(block["key"], tree["key"])
        # the flat manager (the loop driver's restore)
        flat = CheckpointManager(directory, async_write=False)
        back, step = flat.restore_latest(target)
        assert step == 2 and flat.last_extra == extra
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(_agents(back)) + [back["key"]],
            leaves(_agents(tree)) + [tree["key"]]))


def test_port_steps_restore_in_the_reference(tmp_path, states):
    jstate, struct, state = states
    n = len(jax.tree.leaves(jstate["aips"])[0])
    extra = {"async_round": None, "reports": [0] * n}
    _port_two_ranks(str(tmp_path), state, 2, extra)
    tree, step = jdckpt.read_step_host(str(tmp_path / "step_2"), struct)
    assert step == 2 and tree["round"] == 2
    assert_tree_equal(jax.tree.map(np.asarray, _agents(tree)),
                      _agents(jstate))
    assert np.asarray(tree["key"]).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(tree["key"]), jstate["key"])
    jm = jdckpt.DistributedCheckpointManager(str(tmp_path))
    assert jm.latest_committed() == 2
    back, _ = JManager(str(tmp_path)).restore_latest(struct)
    assert_tree_equal(jax.tree.map(np.asarray, _agents(back)),
                      _agents(jstate))
    assert jm.restore_latest(struct)[1] == 2 and jm.last_extra == extra


def _small(seed=0, n=4):
    g = torch.Generator().manual_seed(seed)
    return {"ials": {"w": torch.randn(n, 3, generator=g)},
            "aips": {"b": torch.randn(n, generator=g)},
            "round": 1, "key": torch.tensor([0, seed])}


def test_incomplete_prepare_and_corrupted_slice(tmp_path):
    d = str(tmp_path / "step_1")
    st = _small()
    mesh = runtime.ShardMesh(n_shards=2, rank=0, device=CPU)
    block = runtime.shard_agent_tree(_agents(st), mesh)
    dckpt.write_slice(d, {"ials__w": block["ials"]["w"],
                          "aips__b": block["aips"]["b"]}, 0, 2, 4, step=1)
    dckpt.write_replicated(d, {"round": 1, "key": st["key"]}, step=1)
    # only the low slice: the tiling [0, 4) has a gap
    assert dckpt.build_commit_meta(d) is None
    assert jdckpt.build_commit_meta(d) is None
    _port_two_ranks(str(tmp_path), st, 1, {})
    assert dckpt.build_commit_meta(d, expect_n=8) is None
    assert dckpt.committed_meta(d) == jdckpt.committed_meta(d) is not None
    victim = os.path.join(d, "agents-00000-00002", "ials__w.npy")
    with open(victim, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    assert dckpt.committed_meta(d) is None and \
        jdckpt.committed_meta(d) is None


def test_gc_of_uncommitted_steps_and_takeover(tmp_path):
    d = str(tmp_path)
    st = _small()
    for step in (1, 2):
        _port_two_ranks(d, st, step, {"reports": [step] * 4})
    # step 3 fully prepared, never committed: rank 0 gives up at once,
    # before rank 1's slice lands
    for r in range(2):
        mesh = runtime.ShardMesh(n_shards=2, rank=r, device=CPU)
        mgr = dckpt.DistributedCheckpointManager(d, process_id=r, keep=5,
                                                 async_write=False)
        mgr.commit_timeout_s = 0.0
        mgr.save(3, {**st, **runtime.shard_agent_tree(_agents(st), mesh)},
                 extra={"reports": [3] * 4}, mesh=mesh)
    assert not os.path.exists(os.path.join(d, "step_3", "COMMIT"))
    assert dckpt.build_commit_meta(os.path.join(d, "step_3")) is not None
    # step 4 committed, then corrupted
    _port_two_ranks(d, st, 4, {})
    assert chaos.corrupt_checkpoint(os.path.join(d, "step_4"), "bytes")
    survivor = dckpt.DistributedCheckpointManager(d, process_id=1, keep=5)
    assert survivor.latest_committed() == 2
    # takeover: step 4 is unusable, step 3 fully prepared
    assert survivor.finalize_pending() == 3
    assert jdckpt.committed_meta(os.path.join(d, "step_3"))["extra"] == \
        {"reports": [3] * 4}
    assert survivor.finalize_pending() is None
    target = _zeros(st)
    tree, step = dckpt.DistributedCheckpointManager(
        d, keep=5).restore_latest(target)
    assert step == 3 and torch.equal(tree["ials"]["w"], st["ials"]["w"])
    # rank 0 deleted the corrupted newer step on the way
    assert dckpt.DistributedCheckpointManager(d).steps() == [1, 2, 3]
