"""Recovery scenario A of the port (``repro_torch.distributed.recovery``),
as the reference's ``tests/test_recovery.py::
test_nonprimary_death_recovers_from_rank0_commit``: rank 1's checkpoint
writer SIGKILLs the process right after preparing its step-2 slice (a
heartbeat delay parks its main thread, so it never beats round 2 and dies
outside any collective). Rank 0 commits step 2, its gate times out, and
it re-executes solo, resuming at round 2 (``tests/_torch_procs.
recovery_scenario`` holds the outcome)."""
import pytest

pytest.importorskip("torch")

import _torch_procs as procs


def test_nonprimary_death_recovers_from_rank0_commit(tmp_path):
    events = procs.recovery_scenario(
        tmp_path, "crash@2:host=1:phase=prepared,delay@2:host=1:delay_s=30",
        dead_rank=1, resume_rounds=[2, 3, 4])
    fin = [e for e in events if e["event"] == "recovery_finalize"]
    assert fin and fin[0]["step"] is None and fin[0]["latest"] == 2, fin
