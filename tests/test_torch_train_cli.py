"""The port's LM training entry points on the CPU: ``python -m
repro_torch.launch.train`` (``launch/train.py``), its stop-and-resume
through ``--ckpt`` bit for bit, ``examples/torch_train_lm_outer.py``, and
the ``{"params", "opt", "outer"}`` checkpoint of the reference's example
crossing between the packages both ways, bit for bit (the reference's
int32 step comes back as the port's int64 and back).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import assert_tree_equal, to_np
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import outer as jouter
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import steps, train
from repro_torch.optim import adamw, outer
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--reduced", "--steps", "8", "--batch", "2",
        "--seq", "16", "--sync-every", "2", "--log-every", "1"]


def env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def final_digests(d):
    """The last checkpoint's leaf digests (bit-for-bit identity)."""
    mgr = CheckpointManager(d)
    step = mgr.steps()[-1]
    manifest = ckpt.load_manifest(os.path.join(d, f"step_{step}"))
    return step, {e["name"]: e["sha256"] for e in manifest["leaves"]}


def test_train_cli_stopped_and_resumed_ends_bit_for_bit(tmp_path, capsys):
    """8 steps with a reconciliation every 2 steps: straight, and stopped
    after 3 steps (its last checkpoint at step 2), then resumed. Both end
    on the same step-8 checkpoint, params, AdamW state, outer state and
    compression error, bit for bit."""
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    p_a, o_a = train.main(ARGS + ["--ckpt", straight])
    train.main(ARGS + ["--ckpt", resumed, "--stop-after", "3"])
    assert CheckpointManager(resumed).steps() == [2]
    p_b, o_b = train.main(ARGS + ["--ckpt", resumed])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "tok/s" in out
    assert final_digests(straight) == final_digests(resumed)
    assert final_digests(straight)[0] == 8
    names = set(final_digests(straight)[1])
    assert {"params__embed__table.npy", "opt__step.npy",
            "outer__anchor__embed__table.npy",
            "err__embed__table.npy"} <= names
    assert all(torch.equal(x, y) for x, y in zip(leaves(p_a), leaves(p_b)))
    assert all(torch.equal(x, y) for x, y in zip(leaves(o_a), leaves(o_b)))
    assert int(o_a["step"]) == 8


def test_train_module_runs_every_kind(capsys):
    """``python -m repro_torch.launch.train`` on an enc-dec architecture
    (zero stub frames), then ``main`` in process on a decoder-only and a
    VLM one (zero stub patches): the reference's log lines, finite."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "whisper-tiny", "--device", "cpu", "--reduced", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1"],
        capture_output=True, text=True, env=env(), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    logs = {"whisper-tiny": out.stdout}
    for arch in ("tinyllama-1.1b", "llama-3.2-vision-90b"):
        train.main(["--arch", arch, "--device", "cpu", "--reduced",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
        logs[arch] = capsys.readouterr().out
    for arch, text in logs.items():
        lines = text.splitlines()
        assert lines[0].startswith(f"{arch} (reduced): ") and \
            lines[0].endswith(
                "M params on cpu, mesh {'data': 1, 'model': 1}")
        assert [ln.split()[:2] for ln in lines[1:]] == [
            ["step", "0"], ["step", "1"]]
        assert all(np.isfinite(float(ln.split()[3])) for ln in lines[1:])


def test_train_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])


def test_example_runs_on_cpu(tmp_path):
    """``examples/torch_train_lm_outer.py`` a few steps, then resumed from
    its checkpoint."""
    cmd = [sys.executable, os.path.join(ROOT, "examples",
                                        "torch_train_lm_outer.py"),
           "--device", "cpu", "--batch", "2", "--seq", "16",
           "--sync-every", "3", "--ckpt", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "6"], capture_output=True,
                           text=True, env=env(), timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "done" in first.stdout and "step    5" in first.stdout
    again = subprocess.run(cmd + ["--steps", "8"], capture_output=True,
                           text=True, env=env(), timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "resumed from step 6" in again.stdout


def _states():
    """The reference example's state tree of reduced tinyllama after an
    outer step moved it, and the port's of the same values."""
    spec = jregistry.get("tinyllama-1.1b", reduced=True)

    @jax.jit        # one program (called as is, each op compiles alone)
    def jstates(key):
        params = japi.init(key, spec)
        opt = jadamw.init(params)
        opt = dict(opt, step=jnp.asarray(5, jnp.int32))
        moved = jax.tree.map(lambda p: p + jnp.asarray(0.01, p.dtype),
                             params)
        out_state = jouter.outer_step(moved, jouter.init(params),
                                      jouter.OuterConfig())[1]
        return {"params": params, "opt": opt, "outer": out_state}

    jstate = jstates(jax.random.PRNGKey(0))
    tspec = registry.get("tinyllama-1.1b", reduced=True)
    tp = steps.init_params(tspec, seed=1, device="cpu")
    tstate = {"params": tp, "opt": adamw.init(tp, per_agent=False),
              "outer": outer.init(tp)}
    return jstate, tstate


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, target = _states()
    mgr = JManager(str(tmp_path), async_write=False)
    mgr.save(4, jstate)
    back, step = CheckpointManager(str(tmp_path)).restore_latest(target)
    assert step == 4
    assert back["opt"]["step"].dtype == torch.int64
    assert int(back["opt"]["step"]) == 5
    for x, t in zip(leaves(back), leaves(target)):
        assert x.dtype == t.dtype and x.shape == t.shape
    assert_tree_equal(to_np(back), jax.device_get(jstate))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _states()
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(6, tstate)
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          jstate)
    back, step = JManager(str(tmp_path)).restore_latest(target)
    assert step == 6
    assert np.asarray(back["opt"]["step"]).dtype == np.int32
    for x, t in zip(jax.tree.leaves(back), jax.tree.leaves(target)):
        assert x.dtype == t.dtype and x.shape == t.shape
    assert_tree_equal(jax.device_get(back), to_np(tstate))
