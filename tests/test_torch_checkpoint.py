"""The port's checkpoints (``repro_torch.checkpoint``): the reference's
single-process cases (``tests/test_checkpoint.py``) on the port, a port
checkpoint read by the reference's ``ckpt.restore`` into the reference's
state structure, and the loop driver's resume on the CPU, bit for bit:
one round + restore + one round equals two rounds straight."""
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal
from repro.checkpoint import ckpt as jckpt
from repro.core import dials as jdials
from repro.core import influence as jinf
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro_torch import random as R
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import dials, influence
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo
from repro_torch.tree import leaves, tree_map


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(4, 8, generator=g),
                      "b": torch.zeros(8, dtype=torch.bfloat16) + 0.5},
            "step": torch.ones((), dtype=torch.int64),
            "stack": [torch.arange(3), torch.ones(2, dtype=torch.bool)]}


def _assert_same(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _corrupt(d, data=b"\xde\xad\xbe\xef"):
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(data)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree(0)
    d = str(tmp_path / "c1")
    ckpt.save(d, tree, step=7, extra={"reports": [1, 2]})
    assert ckpt.is_valid(d)
    assert ckpt.load_manifest(d)["extra"] == {"reports": [1, 2]}
    names = {e["name"]: e["dtype"] for e in ckpt.load_manifest(d)["leaves"]}
    assert names["layer__b.npy"] == "bfloat16" and "stack__1.npy" in names
    target = tree_map(torch.zeros_like, tree)
    back, step = ckpt.restore(d, target)
    assert step == 7
    _assert_same(tree, back)
    # a Python scalar leaf comes back as its type
    ckpt.save(d, {"round": 3, "x": torch.ones(2)}, step=3)
    back, _ = ckpt.restore(d, {"round": 0, "x": torch.zeros(2)})
    assert back["round"] == 3 and isinstance(back["round"], int)


def test_corruption_detected(tmp_path):
    d = str(tmp_path / "c2")
    ckpt.save(d, _tree(1), step=1)
    _corrupt(d)
    assert not ckpt.is_valid(d)


def test_missing_manifest_invalid(tmp_path):
    assert not ckpt.is_valid(str(tmp_path / "nope"))


def test_manager_rotation_and_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = _tree(2)
    for s in (1, 2, 3):
        mgr.save(s, {**tree, "layer": {**tree["layer"],
                                       "w": tree["layer"]["w"] + s}})
    mgr.wait()
    assert mgr.steps() == [2, 3]          # keep=2 rotated out step 1
    back, step = mgr.restore_latest(tree_map(torch.zeros_like, tree))
    assert step == 3
    assert torch.equal(back["layer"]["w"], tree["layer"]["w"] + 3)
    back, step = mgr.restore_step(2, tree_map(torch.zeros_like, tree))
    assert step == 2
    assert mgr.restore_step(1, tree) == (None, -1)


def test_manager_skips_corrupt_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    tree = _tree(3)
    mgr.save(1, tree, extra={"reports": [0]})
    mgr.save(2, tree_map(lambda x: x * 2, tree), extra={"reports": [1]})
    mgr.wait()
    _corrupt(os.path.join(str(tmp_path), "step_2"), b"\x00\x00\x00\x00")
    back, step = mgr.restore_latest(tree_map(torch.zeros_like, tree))
    assert step == 1
    _assert_same(tree, back)
    assert mgr.last_extra == {"reports": [0]}


def test_restore_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    back, step = mgr.restore_latest({"x": torch.zeros(1)})
    assert back is None and step == -1


def test_async_write_failure_reraised_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)

    def exploding_hook(step, phase, directory):
        if phase == "leaves_written":
            raise OSError("disk full (injected)")

    mgr.hooks = exploding_hook
    mgr.save(1, _tree(0))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    # the error is consumed: the manager is usable again
    mgr.hooks = None
    mgr.save(2, _tree(0))
    mgr.wait()
    assert mgr.steps() == [2]


def test_async_write_failure_reraised_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    boom = {"on": True}

    def hook(step, phase, directory):
        if boom["on"] and phase == "write_begin":
            raise RuntimeError("writer died (injected)")

    mgr.hooks = hook
    mgr.save(1, _tree(0))
    while mgr._thread is not None and mgr._thread.is_alive():
        mgr._thread.join(0.01)
    boom["on"] = False
    with pytest.raises(RuntimeError, match="writer died"):
        mgr.save(2, _tree(0))


def test_distributed_layout_refused(tmp_path):
    """A step in the reference's per-slice layout is refused by name,
    not skipped as torn."""
    os.makedirs(tmp_path / "step_4" / "agents-0-2")
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        mgr.restore_latest({"x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the loop driver's checkpoints
# ---------------------------------------------------------------------------
ENV = dict(side=2, horizon=16)
POLICY = dict(kind="gru", hidden=(16,), gru_hidden=8)
AIP = dict(kind="gru", hidden=(16,), gru_hidden=8, epochs=3, batch=4)
DIALS = dict(aip_refresh=2, collect_envs=4, collect_steps=16, n_envs=4,
             rollout_steps=8, eval_episodes=2)
PPO = dict(epochs=1, minibatches=2)


def _trainer(rounds, ckpt_dir=None):
    mod, cfg = registry.make("warehouse", **ENV)
    info = cfg.info()
    return dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions, **POLICY),
        influence.AIPConfig(info.alsh_dim, info.n_influence, **AIP),
        ppo.PPOConfig(**PPO),
        dials.DIALSConfig(outer_rounds=rounds, ckpt_dir=ckpt_dir, **DIALS),
        device="cpu")


_TIMES = ("collect_s", "env_steps_per_s", "aip_s", "inner_s", "eval_s",
          "round_s", "wall_s")


def test_resume_is_bitwise_on_cpu(tmp_path):
    d = str(tmp_path)
    straight, hist = _trainer(2).run(R.key(4))
    _, first = _trainer(1, d).run(R.key(4))
    assert [r["round"] for r in first] == [0]
    assert os.listdir(d) == ["step_1"]
    # a key that would start another run: the checkpoint's key wins
    resumed, second = _trainer(2, d).run(R.key(99))
    assert [r["round"] for r in second] == [1]
    for k, v in hist[1].items():
        if k not in _TIMES:
            assert second[0][k] == v, k
    assert resumed["round"] == straight["round"] == 2
    _assert_same({k: straight[k] for k in ("ials", "aips", "key")},
                 {k: resumed[k] for k in ("ials", "aips", "key")})
    assert sorted(os.listdir(d)) == ["step_1", "step_2"]


def test_reference_reads_port_checkpoint(tmp_path):
    """A port checkpoint restores through the reference's ``ckpt.restore``
    into the reference trainer's own state structure with equal arrays
    (int64 keys and counters cast back to uint32/int32)."""
    d = str(tmp_path)
    state, _ = _trainer(1, d).run(R.key(2))
    jmod, jcfg = jreg.make("warehouse", **ENV)
    info = jcfg.info()
    jtr = jdials.DIALSTrainer(
        jmod, jcfg, jpol.PolicyConfig(info.obs_dim, info.n_actions,
                                      use_kernels="off", **POLICY),
        jinf.AIPConfig(info.alsh_dim, info.n_influence, use_kernels="off",
                       **AIP),
        jppo.PPOConfig(use_kernels="off", **PPO),
        jdials.DIALSConfig(shards=1, use_kernels="off", outer_rounds=1,
                           **DIALS))
    target = jtr._state_struct(jtr.init(jax.random.PRNGKey(0)))
    back, step = jckpt.restore(os.path.join(d, "step_1"), target)
    assert step == 1 and back["round"] == 1
    assert jax.tree.structure(back) == jax.tree.structure(target)
    for x, t in zip(jax.tree.leaves(back), jax.tree.leaves(target)):
        assert getattr(x, "dtype", None) == getattr(t, "dtype", None)
    arrays = ("ials", "aips", "key")
    assert len(jax.tree.leaves({k: back[k] for k in arrays})) == \
        len(leaves({k: state[k] for k in arrays}))
    assert_tree_equal({k: back[k] for k in arrays},
                      {k: state[k] for k in arrays})
    assert np.asarray(back["key"]).dtype == np.uint32
