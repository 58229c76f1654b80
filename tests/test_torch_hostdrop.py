"""The port's elastic host-loss path end to end: two gloo ranks on the
CPU (``tests/_torch_multihost_check.py --mode hostdrop``), rank 1
SIGKILLed at the top of round 2. The survivor's ``fault.HostMonitor``
gate declares it dead, the driver reassigns its agent block
(``fault.elastic_plan``) onto the survivor's own mesh
(``runtime.survivor_mesh``) and finishes the run alone, as the
reference's ``tests/test_multihost.py::
test_host_drop_triggers_elastic_reassignment`` does on four shards.

The survivor continues from the mirror of the end of round 1, which is
what the run committed as step 2, so its final state must be bit for bit
a one-shard run resumed from that step in this process (the
distributed manager restoring two slices onto one shard, with a
``restore_reshard`` event). Against the uninterrupted loop run, the
tolerances of the port's two-rank tests: AIPs and policy 1e-6
(``tests/test_torch_sharded.py``)."""
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

import _torch_procs as procs
from repro_torch import random as R
from repro_torch.analysis import programs
from repro_torch.obs import sinks
from repro_torch.tree import leaves
from tools import telemetry_report


def _leaves(tree):
    return leaves(tree["aips"]) + leaves(tree["ials"])


def test_host_drop_reassigns_to_the_survivor(tmp_path):
    out = str(tmp_path / "hostdrop.pt")
    ck, tel = str(tmp_path / "ck"), str(tmp_path / "tel")
    ranks = procs.launch(procs.MULTIHOST, [
        "--mode", "hostdrop", "--out", out, "--beat-dir",
        str(tmp_path / "beats"), "--ckpt-dir", ck, "--telemetry-dir", tel])
    (rc0, log0), (rc1, log1) = procs.wait_all(ranks, timeout=240)
    assert rc0 == 0 and "MULTIHOST-OK" in log0, log0[-3000:]
    assert rc1 == -9, f"rank 1 was not SIGKILLed: rc={rc1}\n{log1[-2000:]}"

    got = torch.load(out, weights_only=False)
    hist = got["history"]
    assert [r["n_shards"] for r in hist] == [2, 2, 1, 1], hist
    assert [r["dead_hosts"] for r in hist] == [[], [], [1], []]
    assert [r["reassigned"] for r in hist] == [0, 0, 1, 0]
    assert all(r["mirror_s"] is not None for r in hist)
    assert got["gate_wait_s"] < 3.5       # the last gate: no one to wait

    # the merged event log tells the incident: death, then the re-plan
    events = telemetry_report.load_events(tel)
    assert telemetry_report.check(events) == [], \
        telemetry_report.check(events)
    assert telemetry_report.main([tel, "--check"]) == 0
    death = [e for e in events if e["event"] == "host_death"]
    assert death and death[0]["dead_hosts"] == [1], death
    plan = [e for e in events if e["event"] == "elastic_reassign"]
    assert plan and (plan[0]["old_shards"], plan[0]["new_shards"],
                     plan[0]["moved"]) == (2, 1, {"1": 0}), plan
    r1 = [e["round"] for e in events
          if e["event"] == "round" and e["proc"] == 1]
    assert r1 == [0, 1], r1

    # a one-shard resume from step 2 in this process
    one = str(tmp_path / "one")
    os.makedirs(one)
    shutil.copytree(os.path.join(ck, "step_2"), os.path.join(one, "step_2"))
    tel1 = str(tmp_path / "tel1")
    tr = programs.tiny_trainer("traffic", device="cpu", outer_rounds=4,
                               ckpt_dir=one, telemetry_dir=tel1)
    state, history = tr._run_sharded(None, 1, key=R.key(0), log=None,
                                     straggler_mask=None)
    assert [r["round"] for r in history] == [2, 3]
    reshard = [e for e in sinks.read_jsonl(sinks.proc_path(tel1, 0))
               if e["event"] == "restore_reshard"]
    assert reshard and (reshard[0]["old_shards"],
                        reshard[0]["new_shards"]) == (2, 1), reshard
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(state)))
    timeless = [{k: v for k, v in r.items()
                 if k not in ("round_s", "wall_s", "mirror_s", "n_shards",
                              "reassigned", "dead_hosts")}
                for r in hist[2:]]
    assert timeless == [{k: v for k, v in r.items()
                         if k not in ("round_s", "wall_s", "mirror_s",
                                      "n_shards", "reassigned",
                                      "dead_hosts")} for r in history]

    # against the uninterrupted loop run
    loop, _ = programs.tiny_trainer("traffic", device="cpu",
                                    outer_rounds=4).run(R.key(0))
    for a, b in zip(_leaves(got), _leaves(loop)):
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 1e-6
        else:
            assert np.array_equal(a.numpy(), b.numpy())
