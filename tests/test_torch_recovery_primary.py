"""Recovery scenario B of the port (``repro_torch.distributed.recovery``),
as the reference's ``tests/test_recovery.py::
test_primary_death_finalized_by_survivor_takeover``: rank 0 dies at
``pre_commit`` of step 3, after every slice verified and before COMMIT.
The store is the external coordinator, so rank 0's death leaves the
survivor's coordination intact; the survivor's ``recover()`` finalizes
the pending commit (takeover) and re-executes solo, resuming at round 3:
no completed round is lost to the primary's death."""
import pytest

pytest.importorskip("torch")

import _torch_procs as procs


def test_primary_death_finalized_by_survivor_takeover(tmp_path):
    events = procs.recovery_scenario(
        tmp_path,
        "crash@3:host=0:phase=pre_commit,delay@3:host=0:delay_s=30",
        dead_rank=0, resume_rounds=[3, 4])
    fin = [e for e in events if e["event"] == "recovery_finalize"]
    assert fin and fin[0]["step"] == 3, fin
