"""The port's experiment harness (``benchmarks/torch_run.py``), the DIALS
half of ``repro_torch.launch.variants``, the sharded rows of
``benchmarks/torch_scaling.py``, and a guard that no file of the port
imports JAX or the JAX package.

* ``table_lemma2`` and ``table_memory`` against ``benchmarks/run.py``'s
  (floats within 1e-12, flags and byte counts exact; ``table_memory``'s
  ``*_port`` columns count the port's int64 leaves at 8 bytes), both run
  with the working directory in ``tmp_path``;
* one ``fig3_learning`` cell (warehouse, the reference's widths, one
  round of F=1), started from the reference's init through
  ``repro_torch.convert``, against the reference's DIALS, untrained-DIALS
  and GS runs: ``final_gs_return`` within 1e-6, ``aip_ce_final`` within
  1e-5 (``tests/test_torch_dials.py``'s tolerances);
* the CLI: ``--device cpu --fast --only table_lemma2`` writes its JSON
  and the reference's lines; an unknown bench is refused, ``--sharded-gs
  on`` without ``--shards N > 1`` raises as ``DIALSTrainer.run`` does,
  ``--device cuda`` raises without a card;
* ``--shards 2`` with ``--sharded-gs on`` and ``off``: one
  ``fig3_learning`` cell (warehouse, one round of F=1) on two spawned
  gloo ranks, its rows under the same labels and keys as the one-process
  run's;
* ``torch_scaling.py``'s ``--shards 1,2`` rows on the CPU (two gloo
  ranks, narrow widths), which validate against ``SCALING_ROW_SCHEMA``,
  and its refusals of a bad ``--shards`` (``tests/test_torch_scaling.py``
  holds its other modes).
"""
import argparse
import ast
import functools
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import to_torch
from benchmarks import run as jrun
from benchmarks import torch_run
from repro.core import dials as jdials
from repro.launch import variants as jvariants
from repro.marl import runner as jrunner
from repro.obs import metrics as jmetrics
from repro_torch import convert
from repro_torch.tree import leaves as leaves_of
from repro_torch.launch import variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's fig3_learning DIALS cell (benchmarks/run.py:84-91)
FIG3_DIALS = dict(collect_envs=8, collect_steps=64, n_envs=8,
                  rollout_steps=16, eval_episodes=8)


def _bench_json(name):
    with open(os.path.join("experiments", "bench", f"{name}.json")) as f:
        return json.load(f)


def test_table_lemma2_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want, got = jrun.table_lemma2(), torch_run.table_lemma2()
    assert [r["label"] for r in got] == [r["label"] for r in want]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in ("xi", "lhs_maxQdiff", "bound"):
            assert isinstance(g[k], float)
            assert abs(g[k] - w[k]) <= 1e-12, (w["label"], k, g[k], w[k])
        assert g["holds"] == w["holds"] == 1
    assert _bench_json("torch_table_lemma2") == json.loads(
        json.dumps(got, default=float))
    assert len(_bench_json("table_lemma2")) == len(got)


def test_table_memory_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want, got = jrun.table_memory(), torch_run.table_memory(device="cpu")
    ref_cols = [{k: v for k, v in r.items() if not k.endswith("_port")}
                for r in got]
    assert ref_cols == [{k: int(v) if k != "label" else v
                         for k, v in r.items()} for r in want]
    # the port holds the reference's int32/uint32 leaves as int64
    from repro_torch import random as R
    from repro_torch.envs import registry
    for r, env_name in zip(got[-len(torch_run._env_names()):],
                           torch_run._env_names()):
        mod, cfg = registry.make(env_name, side=10)
        for init, col in ((mod.gs_init, "gs_state_bytes"),
                          (mod.ls_init, "ls_state_bytes_per_agent")):
            tree = init(R.key(0, device="cpu"), cfg)
            leaves = leaves_of(tree)
            n_int = sum(x.numel() for x in leaves
                        if not x.dtype.is_floating_point
                        and x.dtype != torch.bool)
            assert all(x.dtype != torch.int32 for x in leaves)
            assert r[col + "_port"] == r[col] + 4 * n_int, (r["label"], col)
        assert r["ls_total_bytes_port"] == \
            r["ls_state_bytes_per_agent_port"] * r["n_agents"]
    assert _bench_json("torch_table_memory") == got


def test_fig3_env_rows_match_reference_round():
    env = "warehouse"
    jmod, jcfg, _info, jpc, jac, jppo = jrun._setup(env, 2)
    key = jax.random.PRNGKey(0)
    want, state0 = {}, None
    for untrained in (False, True):
        tr = jdials.DIALSTrainer(jmod, jcfg, jpc, jac, jppo,
                                 jdials.DIALSConfig(
                                     outer_rounds=1, aip_refresh=1,
                                     untrained=untrained, use_kernels="auto",
                                     **FIG3_DIALS,
                                     **jvariants.dials_variant_for(None)))
        if state0 is None:
            state0 = jax.device_get(tr.init(key))
        _, hist = tr.run(key)
        assert jmetrics.validate_round(hist[0]) == []
        want[untrained] = hist[-1]
    init_fn, train_fn, eval_fn = jrunner.make_gs_trainer(
        jmod, jcfg, jpc, jppo, jrunner.RunConfig(n_envs=8, rollout_steps=16))
    gs0 = jax.device_get(init_fn(key))
    gs, _ = train_fn(gs0)
    want_gs = float(eval_fn(gs["params"], jax.random.PRNGKey(1), episodes=8))

    rows = torch_run.fig3_env_rows(
        env, rounds=1, inner=1, device="cpu",
        state=convert.from_jax_state(state0, "cpu"), gs_state=to_torch(gs0))
    assert [r["label"] for r in rows] == [
        "DIALS-warehouse", "untrained-DIALS-warehouse", "GS-warehouse"]
    for row, untrained in zip(rows, (False, True)):
        rec = want[untrained]
        assert set(row) == {"label", "final_gs_return", "best_gs_return",
                            "aip_ce_final", "wall_s"}
        assert abs(row["final_gs_return"] - rec["gs_return"]) <= 1e-6, row
        assert row["best_gs_return"] == row["final_gs_return"]
        assert abs(row["aip_ce_final"] - rec["aip_ce_after"]) <= 1e-5, row
    assert set(rows[2]) == {"label", "final_gs_return", "wall_s"}
    assert abs(rows[2]["final_gs_return"] - want_gs) <= 1e-6, rows[2]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_writes_json_and_the_reference_lines(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "torch_run.py"),
         "--device", "cpu", "--fast", "--only", "table_lemma2"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if not ln.startswith("#")]
    assert lines[0] == "name,metric,value"
    rows = json.loads((tmp_path / "experiments" / "bench" /
                       "torch_table_lemma2.json").read_text())
    assert lines[1:] == [f"table_lemma2.{r['label']},{k},{v}"
                         for r in rows for k, v in r.items() if k != "label"]
    assert len(lines) == 1 + 5 * 4


@pytest.mark.parametrize("argv,match", [
    (["--only", "fig5"], "unknown bench"),
    (["--sharded-gs", "on", "--only", "fig4_f_sweep"],
     "requires the sharded runtime"),
    (["--sharded-gs", "on", "--shards", "1", "--only", "fig4_f_sweep"],
     "requires the sharded runtime"),
])
def test_cli_refusals(argv, match, capsys):
    """An unknown bench is an argument error; ``--sharded-gs on`` without
    ``--shards N > 1`` raises from the first DIALS run, before any round,
    as the reference's ``DIALSTrainer.run`` does."""
    if "--sharded-gs" not in argv:
        with pytest.raises(SystemExit) as exc:
            torch_run.main(["--device", "cpu", *argv])
        assert exc.value.code == 2
        assert match in capsys.readouterr().err
        return
    with pytest.raises(ValueError, match=match):
        torch_run.main(["--device", "cpu", "--fast", *argv])


@pytest.fixture(scope="module")
def fig3_one_process():
    """warehouse's ``fig3_env_rows`` in this process, one round of F=1."""
    return torch_run.fig3_env_rows("warehouse", shards=1, rounds=1, inner=1,
                                   device="cpu")


@pytest.mark.parametrize("sharded_gs", ["on", "off"])
def test_fig3_env_rows_on_two_spawned_ranks(sharded_gs, fig3_one_process):
    """``--shards 2 --sharded-gs on|off`` runs the DIALS cells on two gloo
    ranks spawned by ``bootstrap.spawn_local`` (rank 0's records), the GS
    collect region-decomposed (``on``: warehouse at side 2 splits into two
    blocks) or replicated (``off``); the rows carry the labels and keys of
    the one-process run, finite, and the GS row (run in this process) is
    the same."""
    one = fig3_one_process
    two = torch_run.fig3_env_rows("warehouse", shards=2, rounds=1, inner=1,
                                  sharded_gs=sharded_gs, device="cpu")
    assert [r["label"] for r in two] == [r["label"] for r in one] == [
        "DIALS-warehouse", "untrained-DIALS-warehouse", "GS-warehouse"]
    assert [set(r) for r in two] == [set(r) for r in one]
    assert all(np.isfinite(v) for r in two for k, v in r.items()
               if k != "label")
    assert two[2]["final_gs_return"] == one[2]["final_gs_return"]


def test_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_run.main(["--only", "table_lemma2"])


# ---------------------------------------------------------------------------
# launch/variants.py, the DIALS half
# ---------------------------------------------------------------------------
def test_variants_match_reference():
    assert variants.MARL_SCENARIOS == jvariants.MARL_SCENARIOS
    for name in variants.MARL_SCENARIOS:
        for kw in ({}, {"horizon": 32}):
            mod, cfg = variants.marl_scenario(name, **kw)
            jmod, jcfg = jvariants.marl_scenario(name, **kw)
            assert mod.__name__.rsplit(".", 1)[1] == \
                jmod.__name__.rsplit(".", 1)[1]
            assert cfg.info() == jcfg.info() or \
                vars(cfg.info()) == vars(jcfg.info())
    for args in ((None,), (1,), (2, True), (4, False, "off"),
                 (2, True, "on", 16), (1, False, "auto", None)):
        assert variants.dials_variant_for(*args) == \
            jvariants.dials_variant_for(*args)


def test_launch_group_wires_the_bootstrap_contract():
    code = ("import os; print(os.environ['DIALS_PROCESS_ID'], "
            "os.environ['DIALS_NUM_PROCESSES'], "
            "os.environ['DIALS_COORDINATOR'])")
    procs = variants.launch_group([sys.executable, "-c", code], processes=2,
                                  stdout=subprocess.PIPE, env={})
    outs = [p.communicate(timeout=60)[0].decode().split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert [o[:2] for o in outs] == [["0", "2"], ["1", "2"]]
    assert outs[0][2] == outs[1][2] and outs[0][2].startswith("127.0.0.1:")
    with pytest.raises(ValueError, match="one shard per process"):
        variants.launch_group([sys.executable, "-c", "pass"], processes=2,
                              local_devices=2)


# ---------------------------------------------------------------------------
# benchmarks/torch_scaling.py --shards
# ---------------------------------------------------------------------------
def test_torch_scaling_sharded_rows():
    # the rows of --shards 1,2 at side 2, two rounds of F=1, built in this
    # process and two spawned gloo ranks at narrow widths: the cell's own
    # widths take minutes a run on the CPU
    import chip_smoke
    from benchmarks import torch_scaling
    from repro_torch.obs import metrics
    args = argparse.Namespace(side=2, rounds=2, inner=1, seed=0, fast=False,
                              telemetry_dir=None)
    pairs = torch_scaling.sharded_rows(
        "warehouse-fnn", [1, 2], args, torch.device("cpu"), lambda: None,
        make_trainer=functools.partial(chip_smoke.make_trainer, small=True))
    rows = [row for row, _ in pairs]
    assert [r["label"] for r in rows] == ["warehouse-fnn-s1",
                                          "warehouse-fnn-s2-p2"]
    for r in rows:
        assert metrics.validate_bench_row(r, metrics.SCALING_ROW_SCHEMA) == []
        assert jmetrics.validate_bench_row(
            r, jmetrics.SCALING_ROW_SCHEMA) == []
    s1, s2 = rows
    assert (s1["fused"], s1["processes"], s1["speedup_vs_unfused"]) == \
        (False, 1, 1.0)
    # the cell's own collect width (make_trainer's small cell: 4 streams)
    assert s1["streams"] == s2["streams"] == 4
    assert s1["collect_s_sharded_gs"] is None and s1["gs_speedup"] is None
    assert (s2["fused"], s2["shards"], s2["processes"]) == (True, 2, 2)
    assert s2["collect_s_sharded_gs"] > 0       # a 2x2 grid tiles 2 bands
    assert s2["gs_speedup"] == pytest.approx(
        s2["collect_s"] / s2["collect_s_sharded_gs"])
    assert s2["speedup_vs_unfused"] == pytest.approx(
        s1["round_s"] / s2["round_s"])
    for _, sp in pairs:
        assert len(sp["serial"]["round_s"]) == 2
    # each rank's kernel launches (the plain versions on the CPU: none)
    assert [set(r["launches"].values()) for r in
            pairs[1][1]["launches_by_rank"]] == [{0}, {0}]


@pytest.mark.parametrize("argv,msg", [
    (["--shards", "0,1"], "--shards must be >= 1"),
    (["--shards", ""], "no row left"),
])
def test_torch_scaling_refuses_bad_shards(argv, msg):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "torch_scaling.py"),
         "--device", "cpu", *argv], capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2 and msg in out.stderr, out.stderr


# ---------------------------------------------------------------------------
# the whole port imports no JAX and nothing of the JAX package
# ---------------------------------------------------------------------------
def _port_files():
    files = sorted(glob.glob(os.path.join(ROOT, "src", "repro_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for pattern in ("benchmarks/torch_*.py", "examples/torch_*.py",
                    "tools/*_torch.py"):
        files += sorted(glob.glob(os.path.join(ROOT, pattern)))
    return [os.path.relpath(f, ROOT) for f in files]


# the reference's scripts outside src/repro that import the JAX package
REFERENCE_SCRIPTS = frozenset(
    ["tools.telemetry_report", "tools.check_programs"]
    + [f"benchmarks.{m}" for m in ("run", "scaling", "kernels", "roofline",
                                   "report", "check_bench")])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return (top in ("jax", "jaxlib") or top == "repro"
            or module in REFERENCE_SCRIPTS)


def _bad_imports(source: str, filename: str = "<source>") -> list:
    """The forbidden modules a source imports (``import``, ``from ...
    import``, ``import_module``/``__import__`` of a constant) or runs as
    ``"-m", "<module>"`` in a list, tuple or call's arguments."""
    bad = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append(node.module)
                bad += [f"{node.module}.{a.name}" for a in node.names
                        if f"{node.module}.{a.name}" in REFERENCE_SCRIPTS]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
        seq = (node.elts if isinstance(node, (ast.List, ast.Tuple))
               else node.args if isinstance(node, ast.Call) else [])
        for flag, arg in zip(seq, seq[1:]):
            if (isinstance(flag, ast.Constant) and flag.value == "-m"
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                bad.append(f"-m {arg.value}")
    return bad


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        bad = _bad_imports(f.read(), path)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("source,want", [
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from repro.obs import metrics", ["repro.obs"]),
    ("from benchmarks import roofline", ["benchmarks.roofline"]),
    ("from tools import telemetry_report", ["tools.telemetry_report"]),
    ("importlib.import_module('benchmarks.check_bench')",
     ["benchmarks.check_bench"]),
    ("subprocess.run([sys.executable, '-m', 'tools.telemetry_report', d,"
     " '--check'])", ["-m tools.telemetry_report"]),
    ("cmd = (sys.executable, '-m', 'benchmarks.kernels', '--fast')",
     ["-m benchmarks.kernels"]),
    ("launch(sys.executable, '-m', 'tools.check_programs')",
     ["-m tools.check_programs"]),
    ("subprocess.run([sys.executable, '-m', 'tools.telemetry_report_torch',"
     " '-m', 'repro_torch.launch.dryrun'])", []),
    ("from benchmarks import torch_roofline, torch_kernels", []),
    ("from tools import check_programs_torch", []),
])
def test_import_guard_reads_every_form(source, want):
    assert _bad_imports(source) == want


def test_import_guard_covers_the_port():
    files = _port_files()
    assert len(files) > 60
    for must in ("chip_smoke.py", "benchmarks/torch_run.py",
                 "src/repro_torch/core/ialm.py",
                 "src/repro_torch/launch/variants.py",
                 "tools/check_programs_torch.py",
                 "tools/telemetry_report_torch.py",
                 "benchmarks/torch_check_bench.py",
                 "benchmarks/torch_report.py"):
        assert must in files
