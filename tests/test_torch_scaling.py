"""The port's scaling bench (``benchmarks/torch_scaling.py``) with the
reference's modes (``benchmarks/scaling.py``), into the port's gate
(``benchmarks/torch_check_bench.py --which scaling``).

* One CLI run on the CPU, ``--fast --rounds 1 --inner 1`` at traffic-2x2,
  shards 1,2, processes 1,2, streams 8, with telemetry: its labels are exactly the reference's three for those arguments, and
  each row has the reference's committed row's non-timing columns
  (``experiments/bench/BENCH_dials_scaling.json``: ``n_agents``,
  ``shards``, ``processes``, ``streams``, ``fused``) and key set, but
  for one key: the port's ``-s2-p2`` row carries ``speedup_vs_unfused``
  against the ``-s1`` row of the same run, where the reference's P=2
  group runs no ``-s1`` (``scaling.py:182-185``). The gate finds
  nothing on the record against itself and exactly the missing row on
  a copy without it; each merged telemetry directory passes
  ``tools/telemetry_report_torch.py --check``; the ``-s2-p2`` row's
  spread holds both ranks' kernel launches (none on the CPU, where the
  wrappers run their plain versions).
* ``--profile-dir`` on a second, smaller run (the stream row alone,
  ``--shards ''``): it wrote ``trace.json`` (~200 MB of host events, so
  the sweep above runs without the profiler).
* The reference's cell: ``torch_scaling.reference_cell`` equals
  ``scaling.py:148-152``'s ``DIALSConfig`` (and ``:225-230``'s with a
  stream width) field for field, but for ``telemetry_fence``, whose
  default is the one the two classes differ in (the port fences its
  phase spans) and which neither cell sets.
* The run sizes (``--fast`` and the cells' own, explicit flags winning)
  and the plan of the reference CI's command line, with its ``# skip``
  lines.
* The refusals: a ``--processes`` list that leaves no row exits 2 and
  names the one-shard-per-process rule; so do ``--rounds 0``, ``--inner
  0`` and an unknown scenario.
"""
import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from benchmarks import torch_check_bench, torch_scaling
from repro.core import dials as jdials
from repro.launch import variants as jvariants
from repro.obs import metrics as jmetrics
from repro_torch.obs import metrics
from tools import telemetry_report_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "benchmarks", "torch_scaling.py")
LABELS = ["traffic-2x2-s1", "traffic-2x2-s2-p2", "traffic-2x2-streams8"]
# the reference's committed rows (benchmarks/scaling.py's artifact)
REFERENCE_ROWS = os.path.join(ROOT, "experiments", "bench",
                              "BENCH_dials_scaling.json")
SHAPE_COLUMNS = ("n_agents", "shards", "processes", "streams", "fused")
# the port's only key beyond the reference's row of the same label
EXTRA_KEYS = {"traffic-2x2-s2-p2": {"speedup_vs_unfused"}}


def _run(*argv, timeout=300):
    return subprocess.run([sys.executable, SCRIPT, "--device", "cpu", *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    d = tmp_path_factory.mktemp("scaling")
    paths = {k: str(d / k) for k in ("T", "R.json")}
    out = _run("--fast", "--rounds", "1", "--scenarios", "traffic-2x2",
               "--shards", "1,2", "--processes", "1,2", "--streams", "8",
               "--inner", "1", "--telemetry-dir", paths["T"],
               "--out", paths["R.json"])
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(paths["R.json"]) as f:
        record = json.load(f)
    return {"record": record, "stdout": out.stdout, **paths}


def test_cli_rows_are_the_references_labels(sweep):
    rows = sweep["record"]["rows"]
    assert [r["label"] for r in rows] == LABELS
    for r in rows:
        assert metrics.validate_bench_row(r, metrics.SCALING_ROW_SCHEMA) \
            == []
        assert jmetrics.validate_bench_row(
            r, jmetrics.SCALING_ROW_SCHEMA) == []
    config = sweep["record"]["config"]
    assert (config["fast"], config["processes"], config["streams"],
            config["shards"]) == (True, [1, 2], [8], [1, 2])
    assert (config["rounds"], config["inner"]) == (1, 1)
    assert sweep["record"]["device"]["platform"] == "cpu"


def test_sharded_row_keeps_its_ranks_launches(sweep):
    ranks = sweep["record"]["spread"]["traffic-2x2-s2-p2"]["launches_by_rank"]
    assert len(ranks) == 2
    wrappers = ("gru_forward", "gru_backward", "gae_forward", "gae_backward")
    for got in ranks:
        # the GRU wrappers also count their cluster and streaming
        # routes' launches
        assert set(got["launches"]) == {
            *wrappers, "gru_forward_stream", "gru_backward_stream",
            "gru_forward_cluster", "gru_backward_cluster"}
        assert set(got["launches"].values()) == {0}
        assert got["by_shape"] == {k: {} for k in wrappers}


def test_cli_rows_match_the_reference_rows(sweep):
    with open(REFERENCE_ROWS) as f:
        reference = {r["label"]: r for r in json.load(f)}
    rows = {r["label"]: r for r in sweep["record"]["rows"]}
    for label, row in rows.items():
        want = reference[label]
        assert {c: row[c] for c in SHAPE_COLUMNS} == \
            {c: want[c] for c in SHAPE_COLUMNS}, label
        assert set(row) - set(want) == EXTRA_KEYS.get(label, set()), label
        assert set(want) <= set(row), label
    s1, s2 = rows["traffic-2x2-s1"], rows["traffic-2x2-s2-p2"]
    assert s1["speedup_vs_unfused"] == 1.0
    assert s2["speedup_vs_unfused"] == pytest.approx(
        s1["round_s"] / s2["round_s"])
    assert s2["collect_s_sharded_gs"] > 0      # a 2x2 grid tiles 2 bands
    assert rows["traffic-2x2-streams8"]["collect_s_sharded_gs"] is None


def test_gate_reads_the_record(sweep, tmp_path, capsys):
    fresh = sweep["R.json"]
    assert torch_check_bench.check("scaling", fresh, fresh,
                                   max_regression=float("inf"),
                                   subset=False) == []
    assert torch_check_bench.main(["--which", "scaling", "--fresh", fresh,
                                   "--baseline", fresh]) == 0
    broken = copy.deepcopy(sweep["record"])
    broken["rows"] = [r for r in broken["rows"]
                      if r["label"] != "traffic-2x2-s2-p2"]
    path = str(tmp_path / "broken.json")
    with open(path, "w") as f:
        json.dump(broken, f)
    assert torch_check_bench.check("scaling", path, fresh,
                                   max_regression=0.25, subset=False) == \
        ["traffic-2x2-s2-p2: row missing from fresh artifact"]
    assert torch_check_bench.main(["--which", "scaling", "--fresh", path,
                                   "--baseline", fresh]) == 1
    assert "traffic-2x2-s2-p2: row missing from fresh artifact" in \
        capsys.readouterr().out


def test_merged_telemetry_passes_the_check(sweep, capsys):
    merged = sorted(root for root, _dirs, files in os.walk(sweep["T"])
                    if "telemetry.jsonl" in files)
    assert [os.path.basename(d) for d in merged] == sorted(
        f"{label}-{mode}" for label in LABELS for mode in ("sync", "async"))
    assert f"# merged telemetry in 6 cell dir(s) under {sweep['T']}" in \
        sweep["stdout"]
    for directory in merged:
        assert telemetry_report_torch.main([directory, "--check"]) == 0
    assert capsys.readouterr().out.count("# telemetry OK:") == 6


def test_profile_wrote_a_trace(tmp_path):
    out = _run("--fast", "--rounds", "1", "--inner", "1", "--scenarios",
               "traffic-2x2", "--shards", "", "--streams", "8",
               "--profile-dir", str(tmp_path / "P"),
               "--out", str(tmp_path / "R.json"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(tmp_path / "R.json") as f:
        assert [r["label"] for r in json.load(f)["rows"]] == \
            ["traffic-2x2-streams8"]
    trace = tmp_path / "P" / "trace.json"
    with open(trace, "rb") as f:
        head = f.read(4096)
    assert os.path.getsize(trace) > 0
    os.remove(trace)                  # hundreds of MB of host events
    assert head.lstrip().startswith(b"{")
    assert b"traceEvents" in head or b"schemaVersion" in head


@pytest.mark.parametrize("shards,overlap,streams", [
    (1, False, None), (1, True, None), (2, False, None), (4, True, None),
    (1, False, 8), (1, True, 512)])
def test_reference_cell_matches_the_reference(shards, overlap, streams):
    # benchmarks/scaling.py:148-152 (:225-230 with a stream width)
    extra = {} if streams is None else {"streams": streams}
    want = jdials.DIALSConfig(
        outer_rounds=2, aip_refresh=4, collect_envs=4, collect_steps=32,
        n_envs=8, rollout_steps=16, eval_episodes=4, telemetry_dir="d",
        **jvariants.dials_variant_for(shards, overlap, **extra))
    got = torch_scaling.reference_cell(2, 4, 32, shards, overlap, streams,
                                       "d")
    # the cell sets what the reference's sets; the one field whose
    # default differs between the two DIALSConfig classes keeps the
    # port's (phase spans fenced on the driver's stream)
    defaults = dataclasses.asdict(type(got)())
    differ = {k for k, v in dataclasses.asdict(type(want)()).items()
              if defaults[k] != v}
    assert differ == {"telemetry_fence"}
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in differ} == \
        {k: v for k, v in want.items() if k not in differ}
    assert all(got[k] == defaults[k] for k in differ)


@pytest.mark.parametrize("scenario,argv,want", [
    ("traffic-2x2", ["--fast"], (2, 4, 32)),
    ("traffic-2x2", [], (4, 20, 64)),
    ("traffic-2x2", ["--fast", "--rounds", "1", "--inner", "3"], (1, 3, 32)),
    ("warehouse-gru", [], (4, 5, None)),
    ("warehouse-gru", ["--fast"], (2, 4, 32)),
    ("traffic", ["--inner", "2"], (4, 2, None)),
])
def test_cell_sizes(scenario, argv, want):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--inner", type=int)
    assert torch_scaling.cell_sizes(scenario, ap.parse_args(argv)) == want


def test_plan_of_the_reference_ci_command(capsys):
    # .github/workflows/ci.yml: --fast --shards 1,2,4,8 --scenarios
    # traffic-2x2,supplychain-line4,powergrid-ring16 --processes 1,2
    # --streams 8,64,512
    scenarios = ["traffic-2x2", "supplychain-line4", "powergrid-ring16"]
    cells, streams = torch_scaling.plan(scenarios, [1, 2, 4, 8], [1, 2],
                                        [8, 64, 512], side=10)
    assert cells == {s: [1, 2] for s in scenarios}
    assert streams == [8, 64, 512]
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "# skip traffic-2x2 shards=4: the port runs one shard per process "
        "(P=4)",
        "# skip traffic-2x2 shards=8: 4 agents not divisible",
        "# skip supplychain-line4 shards=4: the port runs one shard per "
        "process (P=4)",
        "# skip supplychain-line4 shards=8: 4 agents not divisible",
        "# skip powergrid-ring16 shards=4: the port runs one shard per "
        "process (P=4)",
        "# skip powergrid-ring16 shards=8: the port runs one shard per "
        "process (P=8)"]
    # unset, every shard count that divides runs at P = itself
    cells, _ = torch_scaling.plan(["powergrid-ring16"], [1, 2, 4, 8, 16],
                                  None, [], side=10)
    assert cells == {"powergrid-ring16": [1, 2, 4, 8, 16]}


@pytest.mark.parametrize("argv", [
    ["--shards", "1,2", "--processes", "3"],
    ["--shards", "1,4", "--processes", "2"],
])
def test_processes_that_leave_no_row_are_refused(argv):
    out = _run("--scenarios", "traffic-2x2", *argv, timeout=120)
    assert out.returncode == 2, out.stderr
    assert "no row left" in out.stderr and \
        "one shard per process" in out.stderr, out.stderr


@pytest.mark.parametrize("argv,msg", [
    (["--rounds", "0"], "--rounds must be >= 1"),
    (["--inner", "0"], "--inner must be >= 1"),
    (["--scenarios", "traffic-2x2,nowhere"], "unknown scenarios ['nowhere']"),
])
def test_bad_arguments_are_refused(argv, msg):
    out = _run(*argv, timeout=120)
    assert out.returncode == 2 and msg in out.stderr, out.stderr
