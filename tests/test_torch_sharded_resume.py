"""The sharded driver's distributed checkpoints across a kill: two gloo
ranks on the CPU with ``ckpt_dir`` (``tests/_torch_multihost_check.py
--mode resume``). Both ranks are SIGKILLed at the top of round 2 (a chaos
``host_kill``, once their step-2 slices are written); a second launch
resumes from the committed step 2 (each rank reading its block's rows)
and its final state and records are bit for bit those of an
uninterrupted two-rank run. Every step is in the reference's layout: one
slice per rank, ``replicated/`` and a verifying ``COMMIT``."""
import os

import pytest

pytest.importorskip("torch")

import torch

import _torch_procs as procs
from repro_torch.checkpoint import distributed as dckpt
from repro_torch.tree import leaves


def _run(tmp_path, name, ck, *extra):
    out = str(tmp_path / f"{name}.pt")
    return out, procs.wait_all(procs.launch(procs.MULTIHOST, [
        "--mode", "resume", "--out", out, "--ckpt-dir", ck, *extra]),
        timeout=240)


@pytest.mark.parametrize("schedule", ["serial", "async"])
def test_two_rank_run_killed_and_resumed_exactly(tmp_path, schedule):
    """Serial, and with the dispatch-mode collect at bound 2: there the
    step carries the in-flight collect's round (step 2: ``async_round``
    1), and the resumed ranks re-submit it from step 1's params, cut to
    their blocks, so the tags and the state are the uninterrupted
    run's."""
    extra = ("--async-collect",) if schedule == "async" else ()
    ck = str(tmp_path / "ck")
    _, killed = _run(tmp_path, "killed", ck, "--kill-at", "2", *extra)
    assert [rc for rc, _ in killed] == [-9, -9], killed
    assert sorted(os.listdir(ck)) == ["step_1", "step_2"]
    for step in (1, 2):
        d = os.path.join(ck, f"step_{step}")
        assert sorted(os.listdir(d)) == [
            "COMMIT", "agents-00000-00002", "agents-00002-00004",
            "replicated"]
        meta = dckpt.committed_meta(d)
        assert meta["slices"] == [[0, 2], [2, 4]] and meta["n_agents"] == 4
        assert meta["replicated"] == ["key.npy", "round.npy"]
        # saved at the end of round step-1, whose collect is in flight
        assert meta["extra"]["async_round"] == (
            step - 1 if schedule == "async" else None)
        assert len(meta["extra"]["reports"]) == 4
    resumed_out, resumed = _run(tmp_path, "resumed", ck, *extra)
    straight_out, straight = _run(tmp_path, "straight",
                                  str(tmp_path / "ck2"), *extra)
    for rc, log in resumed + straight:
        assert rc == 0, log[-3000:]
    got = torch.load(resumed_out, weights_only=False)
    want = torch.load(straight_out, weights_only=False)
    assert [r["round"] for r in got["history"]] == [2, 3]
    if schedule == "async":
        assert [r["data_round"] for r in want["history"]] == [0, 0, 1, 2]
        assert [r["forced_sync"] for r in got["history"]] == [False, False]
    drop = ("round_s", "wall_s", "collect_s")      # host seconds
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in got["history"]] == \
        [{k: v for k, v in r.items() if k not in drop}
         for r in want["history"][2:]]
    for a, b in zip(leaves(got["aips"]) + leaves(got["ials"]),
                    leaves(want["aips"]) + leaves(want["ials"])):
        assert torch.equal(a, b)
