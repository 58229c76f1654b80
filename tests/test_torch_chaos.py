"""The port's fault injection (``repro_torch.distributed.chaos``) against
the reference (``repro.distributed.chaos``): the same events for the same
spec or seed, ``corrupt_checkpoint`` damaging the same file in the same
way, the hook surfaces (once-only, host and generation filtering, the
``chaos_inject`` event before the act), and a writer crash in raise mode
surfacing through the port's managers."""
import os
import signal

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.distributed import chaos as jchaos
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint import distributed as dckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import chaos, fault

SPECS = ["kill@2:host=1",
         "kill@2:host=1,crash@3:host=0:phase=pre_commit:mode=raise,"
         "corrupt@4:target=commit,delay@1:delay_s=0.5,"
         "interrupt@2:generation=1",
         "crash@2:host=1:phase=prepared,delay@2:host=1:delay_s=30",
         "commit_delay@5:phase=prepared:delay_s=0.1", ""]


class _Rec:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})


def _fields(events):
    return [(e.kind, e.round, e.host, e.phase, e.mode, e.target, e.delay_s,
             e.generation) for e in events]


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_matches_reference(spec):
    assert _fields(chaos.FaultSchedule.from_spec(spec).events) == \
        _fields(jchaos.FaultSchedule.from_spec(spec).events)


def test_seeded_and_refusals_match_reference():
    for seed in range(12):
        for kw in (dict(rounds=6, hosts=2, n_faults=4),
                   dict(rounds=1, hosts=1, n_faults=3,
                        kinds=("writer_crash", "corrupt"))):
            assert _fields(chaos.FaultSchedule.seeded(seed, **kw).events) \
                == _fields(jchaos.FaultSchedule.seeded(seed, **kw).events)
    for bad in ("meteor@1", "kill@1:sev=9"):
        with pytest.raises(ValueError) as want:
            jchaos.FaultSchedule.from_spec(bad)
        with pytest.raises(ValueError) as got:
            chaos.FaultSchedule.from_spec(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("target", ["bytes", "manifest", "commit"])
def test_corrupt_checkpoint_touches_the_same_files(tmp_path, target):
    damaged = []
    for name, mod in (("port", chaos), ("ref", jchaos)):
        d = str(tmp_path / name / "step_1")
        dckpt.write_slice(d, {"w": torch.arange(6.0).reshape(2, 3)}, 0, 2,
                          2, step=1)
        dckpt.write_replicated(d, {"round": 1}, step=1)
        dckpt.write_commit(d, dckpt.build_commit_meta(d))
        path = mod.corrupt_checkpoint(d, target)
        damaged.append((os.path.relpath(path, d),
                        open(path, "rb").read()))
        assert dckpt.committed_meta(d) is None
    assert damaged[0] == damaged[1]
    assert chaos.corrupt_checkpoint(str(tmp_path / "empty"), "bytes") is None


def test_hooks_fire_once_filtered_with_telemetry(tmp_path):
    rec = _Rec()
    s = chaos.FaultSchedule.from_spec("interrupt@2", telemetry=rec)
    s.round_start(1)
    with pytest.raises(chaos.ChaosInterrupt):
        s.round_start(2)
    s.round_start(2)                       # once only
    assert [e["kind"] for e in rec.events] == ["interrupt"]
    killed = []
    chaos.FaultSchedule.from_spec(
        "kill@1:host=3", host=3,
        kill=lambda pid, sig: killed.append((pid, sig))).round_start(1)
    assert killed == [(os.getpid(), signal.SIGKILL)]
    other = chaos.FaultSchedule.from_spec("kill@1:host=1", host=0)
    other.round_start(1)
    gen1 = chaos.FaultSchedule.from_spec("interrupt@1", generation=1)
    gen1.round_start(1)
    assert not other.fired and not gen1.fired
    slept = []
    s = chaos.FaultSchedule.from_spec(
        "delay@2:delay_s=0.3,commit_delay@3:phase=prepared:delay_s=2",
        sleep=slept.append)
    mon = fault.HostMonitor(str(tmp_path), host=0, n_hosts=1, chaos=s)
    mon.beat(1)
    mon.beat(2)
    s.checkpoint_phase(3, "leaves_written", "d")
    s.checkpoint_phase(3, "prepared", "d")
    assert slept == [0.3, 2.0]
    assert os.path.exists(os.path.join(str(tmp_path), "beat-0-2"))


def test_writer_crash_raise_mode_surfaces_via_managers(tmp_path):
    tree = {"w": np.zeros((2, 2), np.float32)}
    for name in ("flat", "distributed"):
        d = str(tmp_path / name)
        mgr = (CheckpointManager(d) if name == "flat"
               else dckpt.DistributedCheckpointManager(d))
        mgr.hooks = chaos.FaultSchedule.from_spec(
            "crash@2:phase=leaves_written:mode=raise").checkpoint_phase
        mgr.save(1, tree)
        mgr.wait()
        mgr.save(2, tree)
        with pytest.raises(chaos.ChaosError):
            mgr.wait()
        mgr.hooks = None
        mgr.save(3, tree)
        mgr.wait()
        committed = [s for s in mgr.steps()
                     if ckpt.is_valid(os.path.join(d, f"step_{s}"))
                     or dckpt.committed_meta(os.path.join(d, f"step_{s}"))]
        assert committed == [1, 3], (name, mgr.steps())
