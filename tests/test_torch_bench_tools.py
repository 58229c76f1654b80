"""The port's bench gate, telemetry report and dry-run report against the
reference scripts they port, on the same inputs (made with numpy from a
seed), and the kernel bench's shape sweep:

* ``benchmarks/torch_check_bench.py`` against ``benchmarks/check_bench.py``
  on fresh/baseline pairs of scaling and kernel rows valid under both
  schemas: a clean pair, a missing row with and without ``--subset``, a
  missing column, a cell gone null, a 30 % throughput regression, a time
  cell 1.5x slower, a shape mismatch (structure only) and an invalid row.
  The problem lists and ``main``'s exit codes are equal. Beside it,
  ``chip_smoke.check_planted_defects`` (the smoke run's gate check) on a
  record shaped as ``torch_kernels --fast`` writes it.
* ``tools/telemetry_report_torch.py`` against ``tools/telemetry_report.py``
  on ``tests/test_obs.py``'s incident log and streams and on a log the
  port's sinks write: every function's output, ``--csv``'s file and
  ``main``'s stdout and exit code are string-equal.
* ``benchmarks/torch_report.py`` against ``benchmarks/report.py`` on
  synthetic dry-run records: the dry-run table is string-equal; with the
  reference's ``roofline.terms`` swapped for ``torch_roofline.terms`` the
  roofline and variant tables are too, and each row's terms equal
  ``torch_roofline.terms`` and ``torch_run.roofline_table``'s.
* ``benchmarks/torch_kernels.swept_shapes`` equals the reference's, fast
  and full.
"""
import copy
import json
import os
import sys
import types

import numpy as np
import pytest

import chip_smoke
from benchmarks import check_bench as jcheck
from benchmarks import kernels as jkernels
from benchmarks import report as jreport
from benchmarks import roofline as jroofline
from benchmarks import torch_check_bench, torch_kernels, torch_report
from benchmarks import torch_roofline, torch_run
from repro_torch import obs as tobs
from repro_torch.obs import metrics as tmetrics
from test_obs import _full_record, _incident_events
from tools import telemetry_report as jtel
from tools import telemetry_report_torch as ttel


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------
def _scaling_doc(rng):
    rows = []
    for scenario, n in (("traffic", 4), ("warehouse", 36)):
        for shards in (1, 2):
            u = lambda lo=0.5, hi=5.0: float(rng.uniform(lo, hi))
            row = {"label": f"{scenario}-{n}agents-P{shards}",
                   "scenario": scenario, "n_agents": n, "shards": shards,
                   "processes": shards, "streams": 8, "fused": shards > 1,
                   "round_s": u(), "round_s_async": u(),
                   "overlap_speedup": u(), "inner_steps_per_s": u(10, 50),
                   "inner_steps_per_s_async": u(10, 50),
                   "total_wall_s": u(), "total_wall_s_async": u(),
                   "collect_s": u(), "env_steps_per_s": u(1e3, 1e4),
                   "collect_s_sharded_gs": u() if shards > 1 else None,
                   "gs_speedup": u() if shards > 1 else None}
            if shards > 1:
                row["speedup_vs_unfused"] = u()
            rows.append(row)
    return rows


def _kernels_doc(rng):
    u = lambda: float(rng.uniform(1e-4, 1e-2))
    roof = lambda: {"compute_s": u(), "memory_s": u(), "step_s": u()}
    micro = []
    for label, b, t, din, h in torch_kernels.swept_shapes(fast=True):
        micro.append({"kernel": "gru", "label": label, "B": b, "T": t,
                      "in": din, "H": h})
    micro += [{"kernel": "gae", "label": r["label"], "B": r["B"],
               "T": r["T"]} for r in micro
              if not r["label"].endswith("-aip")]
    for r in micro:
        for k in ("fwd", "fwdbwd"):
            r[f"{k}_oracle_s"], r[f"{k}_kernel_s"] = u(), u()
            r[f"speedup_{k}"] = r[f"{k}_oracle_s"] / r[f"{k}_kernel_s"]
            r[f"roofline_{k}"] = roof()
    e2e = [{"program": p, "label": lbl, "oracle_s": u(), "kernel_s": u(),
            "speedup": 1.0} for p, lbl in (("train_aip", "warehouse-S8-T16"),
                                           ("ials_inner_step",
                                            "warehouse-E2-T8"))]
    return {"fast": True, "micro": micro, "end_to_end": e2e}


def _rows(which, doc):
    return doc if which == "scaling" else doc["micro"] + doc["end_to_end"]


def _break(which, case, fresh):
    """Apply one defect to ``fresh`` in place."""
    rows = _rows(which, fresh)
    scaling = which == "scaling"
    if case == "missing_row":
        (fresh if scaling else fresh["micro"]).pop(1)
    elif case == "missing_column":
        if scaling:
            del rows[-1]["speedup_vs_unfused"]
        else:
            del rows[0]["in"]
    elif case == "went_null":
        rows[-1 if scaling else 0][
            "collect_s_sharded_gs" if scaling else "fwd_oracle_s"] = None
    elif case == "throughput_30":
        if scaling:
            rows[0]["inner_steps_per_s"] *= 0.7
        else:
            fresh["end_to_end"][0]["kernel_s"] /= 0.7
    elif case == "time_1_5x":
        rows[0]["round_s" if scaling else "fwd_kernel_s"] *= 1.5
    elif case == "shape_mismatch":
        r = rows[0]
        r["n_agents" if scaling else "B"] += 1
        r["inner_steps_per_s" if scaling else "fwdbwd_kernel_s"] *= (
            0.1 if scaling else 10.0)
    elif case == "invalid_row":
        rows[0]["bogus"] = 1
        rows[1]["shards" if scaling else "B"] = "8"


CASES = ("clean", "missing_row", "missing_column", "went_null",
         "throughput_30", "time_1_5x", "shape_mismatch", "invalid_row")


def _expect_findings(which, case, subset) -> bool:
    if case == "missing_row":
        return not subset
    if case == "time_1_5x":               # scaling rows gate no time cell
        return which == "kernels"
    return case not in ("clean", "shape_mismatch")


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", ["scaling", "kernels"])
def test_gate_matches_reference(which, case, subset, tmp_path, monkeypatch,
                                capsys):
    rng = np.random.default_rng(CASES.index(case) + 10 * (which == "kernels"))
    base = _scaling_doc(rng) if which == "scaling" else _kernels_doc(rng)
    fresh = copy.deepcopy(base)
    for r in _rows(which, fresh):         # the same cells, re-measured
        for k, v in r.items():
            if k.endswith("_s") and isinstance(v, float):
                r[k] = v * float(rng.uniform(0.95, 1.05))
    if case != "clean":
        _break(which, case, fresh)
    paths = {}
    for name, doc in (("fresh", fresh), ("base", base)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    kw = dict(max_regression=0.25, subset=subset)
    got = torch_check_bench.check(which, paths["fresh"], paths["base"], **kw)
    want = jcheck.check(which, paths["fresh"], paths["base"], **kw)
    assert got == want
    assert bool(got) == _expect_findings(which, case, subset), got
    capsys.readouterr()
    argv = ["--which", which, "--fresh", paths["fresh"], "--baseline",
            paths["base"]] + (["--subset"] if subset else [])
    rc_port = torch_check_bench.main(argv)
    out_port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["check_bench.py"] + argv)
    rc_ref = jcheck.main()
    out_ref = capsys.readouterr().out
    assert rc_port == rc_ref == (1 if got else 0)
    assert out_port == out_ref


def test_gate_refuses_without_a_committed_baseline(tmp_path):
    path = str(tmp_path / "fresh.json")
    with open(path, "w") as f:
        json.dump(_kernels_doc(np.random.default_rng(0)), f)
    with pytest.raises(SystemExit, match="no committed baseline for "
                       "experiments/bench/BENCH_torch_kernels.json"):
        torch_check_bench.check("kernels", path, "git:HEAD",
                                max_regression=0.25, subset=True)


def test_smoke_gate_finds_each_planted_defect(tmp_path):
    b_path = str(tmp_path / "B.json")
    with open(b_path, "w") as f:
        json.dump(_kernels_doc(np.random.default_rng(1)), f)
    found = chip_smoke.check_planted_defects(torch_check_bench, b_path,
                                             str(tmp_path))
    assert len(found[0]) == 1 and "is null" in found[0][0]
    assert len(found[1]) == 2
    # a gate that misses the defects fails the smoke run's check
    blind = types.SimpleNamespace(SPECS=torch_check_bench.SPECS,
                                  check=lambda *a, **k: [])
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check_planted_defects(blind, b_path, str(tmp_path))


# ---------------------------------------------------------------------------
# the telemetry report
# ---------------------------------------------------------------------------
def _port_log(directory):
    """A two-process recovery story written by the port's sinks."""
    tels = [tobs.Telemetry.create(directory, process_id=p) for p in (0, 1)]
    for p, tel in enumerate(tels):
        tel.emit("run_start", path="sharded", env="warehouse", n_shards=2,
                 kernels="policy=cuda", start_round=0)
        tel.emit_round(tmetrics.round_record(**_full_record(
            round=0, n_shards=2, mirror_s=0.02 + p)))
    tels[0].emit("host_death", round=1, dead_hosts=[1], timeout_s=15.0)
    tels[0].emit("chaos_inject", round=1, kind="crash", host=1)
    tels[0].emit("recovery_begin", round=1, dead=[1], generation=1)
    tels[0].emit("rebootstrap", generation=1, num_processes=1, attempts=2)
    tels[0].emit("restore_reshard", step=0, old_shards=2, new_shards=1)
    tels[0].emit("elastic_reassign", old_shards=2, new_shards=1,
                 dead_blocks=[1], moved={"1": 0})
    tels[0].emit("run_start", path="sharded", env="warehouse", n_shards=1,
                 kernels="policy=cuda", start_round=1)
    tels[0].emit_round(tmetrics.round_record(**_full_record(
        round=1, n_shards=1, reassigned=1, dead_hosts=[1])))
    for tel in tels:
        tel.close()
    return directory


def _logs(tmp_path):
    incident = str(tmp_path / "incident.jsonl")
    with open(incident, "w") as f:
        for e in _incident_events():
            f.write(json.dumps(e) + "\n")
    rec = tmetrics.round_record(**_full_record())
    unordered = str(tmp_path / "unordered.jsonl")
    with open(unordered, "w") as f:
        for i, rnd in enumerate((1, 0)):
            f.write(json.dumps({"event": "round", "proc": 0, "seq": i,
                                "t": float(i), **dict(rec, round=rnd)})
                    + "\n")
    corrupt = str(tmp_path / "corrupt.jsonl")
    with open(corrupt, "w") as f:
        f.write(open(incident).read())
        f.write(json.dumps({"event": "round", "proc": 0, "seq": 99,
                            "t": 9.0, "round": 3}) + "\n")
        f.write(json.dumps({"proc": 0, "seq": 100, "t": 9.5}) + "\n")
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    port = _port_log(str(tmp_path / "port_tel"))
    return {"incident": incident, "unordered": unordered,
            "corrupt": corrupt, "empty": empty, "port": port}


@pytest.mark.parametrize("log", ["incident", "unordered", "corrupt",
                                 "empty", "port"])
def test_telemetry_report_matches_reference(log, tmp_path, capsys):
    path = _logs(tmp_path)[log]
    events = ttel.load_events(path)
    assert events == jtel.load_events(path)
    for fn in ("round_table", "elasticity_timeline", "check",
               "check_recovery"):
        assert getattr(ttel, fn)(events) == getattr(jtel, fn)(events), fn
    csv_path = str(tmp_path / "rounds.csv")
    for flags in ([], ["--check"], ["--check", "--expect-recovery"],
                  ["--csv", csv_path]):
        outs = []
        for tool in (jtel, ttel):
            rc = tool.main([path, *flags])
            csv = (open(csv_path).read() if flags[:1] == ["--csv"] else None)
            outs.append((rc, capsys.readouterr().out, csv))
        assert outs[0] == outs[1], flags
    if log == "port":
        assert ttel.check(events) == [] and ttel.check_recovery(events) == []
        assert outs[0][2].count("\n") == 4       # header + 3 round rows
    if log == "corrupt":
        assert ttel.main([path, "--check"]) == 1


# ---------------------------------------------------------------------------
# the dry-run report
# ---------------------------------------------------------------------------
def _dryrun_records(rng):
    recs = []
    for arch, shape, mesh in (("tinyllama-1.1b", "train_4k", "single"),
                              ("gemma2-9b", "decode_32k", "single"),
                              ("mamba2-780m", "long_500k", "single"),
                              ("yi-34b", "prefill_32k", "multi")):
        flops, nbytes, coll = (float(rng.uniform(1e12, 1e15)),
                               float(rng.uniform(1e10, 1e12)),
                               int(rng.integers(1e8, 1e11)))
        n = 512 if mesh == "multi" else 256
        recs.append({
            "arch": arch, "shape": shape, "mesh": mesh,
            "variant": "baseline", "status": "ok", "n_devices": n,
            "compile_s": round(float(rng.uniform(1, 60)), 2),
            "memory": {"temp_bytes": int(rng.integers(1e9, 5e10))},
            "cost": {"flops": flops, "bytes_accessed": nbytes},
            "collectives": {"total_bytes": coll},
            # the reference's raw-cost fallback, where extrapolation failed
            "cost_extrapolated": ({"error": "ValueError: x"}
                                  if arch == "gemma2-9b" else
                                  {"flops": flops, "bytes_accessed": nbytes,
                                   "collective_bytes": coll}),
            "model_flops_global": (None if arch == "mamba2-780m" else
                                   flops * n * float(rng.uniform(0.4, 0.9)))})
    recs.append({"arch": "whisper-tiny", "shape": "long_500k",
                 "mesh": "single", "variant": "baseline", "status": "skip",
                 "reason": "seq_len exceeds the encoder's context"})
    zero3 = dict(copy.deepcopy(recs[0]), variant="zero3")
    zero3["cost"]["flops"] *= 0.5
    zero3["cost_extrapolated"]["flops"] *= 0.5
    return recs + [zero3]


@pytest.fixture
def dryrun_dir(tmp_path, monkeypatch):
    recs = _dryrun_records(np.random.default_rng(2))
    for sub in ("dryrun", "dryrun_torch"):
        d = tmp_path / "experiments" / sub
        d.mkdir(parents=True)
        for r in recs:
            name = f"{r['arch']}__{r['shape']}__{r['mesh']}__{r['variant']}"
            (d / f"{name}.json").write_text(json.dumps(r))
    monkeypatch.chdir(tmp_path)
    return recs


def test_report_tables_match_reference(dryrun_dir, monkeypatch, capsys):
    for mesh in ("single", "multi"):
        jreport.dryrun_table(mesh)
        want = capsys.readouterr().out
        torch_report.dryrun_table(mesh)
        assert capsys.readouterr().out == want
        assert "| ok |" in want
    # the reference's layout over the card's terms
    monkeypatch.setattr(jroofline, "terms", torch_roofline.terms)
    for run in (lambda m: m.roofline_table("single"),
                lambda m: m.variant_compare("tinyllama-1.1b", "train_4k",
                                            "single",
                                            ["baseline", "zero3", "none"])):
        run(jreport)
        want = capsys.readouterr().out
        run(torch_report)
        assert capsys.readouterr().out == want
    torch_report.main(["--mesh", "multi"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["report.py", "--mesh", "multi"])
    jreport.main()
    assert capsys.readouterr().out == got


def test_report_roofline_terms_are_the_cards(dryrun_dir, capsys):
    rows = {(r["arch"], r["shape"]): r for r in torch_run.roofline_table()
            if r["variant"] == "baseline"}
    capsys.readouterr()
    for rec in dryrun_dir:
        if rec["status"] != "ok" or rec["variant"] != "baseline":
            continue
        terms, ratio = torch_report.roofline_row(rec)
        assert terms == torch_roofline.terms(**torch_roofline.per_device(rec))
        assert terms == {k: rows[(rec["arch"], rec["shape"])][k]
                         for k in terms}
        mf = rec["model_flops_global"]
        assert ratio == (mf / rec["n_devices"] / rec["cost"]["flops"]
                         if mf else None)


# ---------------------------------------------------------------------------
# the kernel bench's shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fast", [True, False])
def test_kernel_bench_shapes_match_reference(fast):
    assert torch_kernels.swept_shapes(fast=fast) == \
        jkernels.swept_shapes(fast)


def test_kernel_bench_refuses_without_a_card(capsys):
    assert torch_kernels.main(["--fast", "--out",
                               os.devnull]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
