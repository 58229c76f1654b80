"""The sharded driver's overlapped collect (``async_collect`` with more
than one shard: ``AsyncCollector(mode="dispatch")``) on two gloo ranks on
the CPU (``tests/_torch_multihost_check.py --mode async``): at
``max_aip_staleness=0`` the records and the final state are bit for bit
the serial sharded run's (every round force-synced), and at 2 the
data-round tags and force-syncs follow the reference's schedule
(``tests/test_async_collect.py``: tags [0, 0, 1])."""
import pytest

pytest.importorskip("torch")

import torch

import _torch_procs as procs
from repro_torch.tree import leaves


def _timeless(history, drop=()):
    return [{k: v for k, v in r.items()
             if k not in ("round_s", "wall_s", *drop)} for r in history]


def test_sharded_async_schedule_on_two_ranks(tmp_path):
    out = str(tmp_path / "async.pt")
    results = procs.wait_all(procs.launch(
        procs.MULTIHOST, ["--mode", "async", "--out", out]), timeout=240)
    for rank, (rc, log) in enumerate(results):
        assert rc == 0, f"rank {rank}:\n{log[-3000:]}"
    got = torch.load(out, weights_only=False)
    serial, zero, two = got["serial"], got["bound0"], got["bound2"]
    assert [r["n_shards"] for r in serial["history"]] == [2, 2, 2]
    # bound 0: the serial schedule, bit for bit
    assert [r["forced_sync"] for r in zero["history"]] == [True] * 3
    assert _timeless(zero["history"], ("forced_sync", "collect_s")) == \
        _timeless(serial["history"], ("forced_sync", "collect_s"))
    for a, b in zip(leaves(zero["aips"]) + leaves(zero["ials"]),
                    leaves(serial["aips"]) + leaves(serial["ials"])):
        assert torch.equal(a, b)
    # bound 2: one round of lag after the blocking prime
    assert [r["data_round"] for r in two["history"]] == [0, 0, 1]
    assert [r["forced_sync"] for r in two["history"]] == \
        [True, False, False]
    assert all(r["collect_s"] is not None for r in two["history"])
