"""Benchmark regression gate of the PyTorch/CUDA port: a freshly written
bench JSON against a baseline — the port of ``benchmarks/check_bench.py``
over the port's artifacts, importing nothing of the JAX package.

``benchmarks/torch_scaling.py`` writes
``experiments/bench/BENCH_torch_dials_scaling.json`` and
``benchmarks/torch_kernels.py [--fast]`` writes
``experiments/bench/BENCH_torch_kernels.json``; this script then fails
(exit 1) when, in this order,

* a fresh row violates its typed schema from ``repro_torch.obs.metrics``
  (``SCALING_ROW_SCHEMA`` / ``KERNELS_MICRO_SCHEMA`` /
  ``KERNELS_E2E_SCHEMA``): unknown columns, missing required columns,
  nulls or wrong types where the schema forbids them (no timing is
  compared then);
* a row present in the baseline is missing from the fresh artifact
  (unless ``--subset``: a ``--fast`` kernel run sweeps fewer shapes than
  a full one), a column present in a baseline row is missing from the
  matching fresh row, or a cell that is non-null in the baseline comes
  back null;
* throughput regresses by more than ``--max-regression`` (default 25 %)
  on any comparable cell; time-valued cells are compared as 1/t. Cells
  are comparable only when the rows agree on their shape columns
  (``B/T/in/H`` for kernel micro rows; scaling rows and end-to-end kernel
  rows carry their sizes in the label); a ``--fast`` row that re-uses a
  label at a smaller shape is structure-checked, never time-compared.
  Every regression message carries the row's phase breakdown
  (``metrics.phase_breakdown``).

The checks, their order and their messages are the reference's. The
baseline defaults to ``git show HEAD:<path>``. No card baseline is
committed (a bound needs the spread of the card's numbers first), so
until one is, ``git:HEAD`` fails with ``no committed baseline for
<path>`` and the gate is run with ``--baseline FILE``.

    python3 benchmarks/torch_kernels.py --fast --out /tmp/a.json
    python3 benchmarks/torch_kernels.py --fast
    python3 benchmarks/torch_check_bench.py --which kernels --subset \\
        --baseline /tmp/a.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis.report import Finding, emit  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

SPECS = {
    "scaling": {
        "path": os.path.join("experiments", "bench",
                             "BENCH_torch_dials_scaling.json"),
        "key": lambda r: r["label"],
        "rows": lambda doc: doc,
        # higher-better cells gated on regression; everything else is
        # structure-checked only (ratio columns bounce with machine load;
        # a vanished cell is the real signal)
        "throughput": ("inner_steps_per_s", "inner_steps_per_s_async",
                       "env_steps_per_s"),
        "times": (),
        "shape_cols": ("n_agents", "shards", "processes", "streams"),
        "schema": lambda r: metrics.SCALING_ROW_SCHEMA,
    },
    "kernels": {
        "path": os.path.join("experiments", "bench",
                             "BENCH_torch_kernels.json"),
        "key": lambda r: (r.get("kernel") or r.get("program"), r["label"]),
        "rows": lambda doc: doc["micro"] + doc["end_to_end"],
        "throughput": (),
        # lower-better: compared as 1/t
        "times": ("fwd_kernel_s", "fwdbwd_kernel_s", "kernel_s"),
        "shape_cols": ("B", "T", "in", "H"),
        # micro rows carry "kernel", end-to-end rows carry "program"
        "schema": lambda r: (metrics.KERNELS_MICRO_SCHEMA
                             if "kernel" in r else
                             metrics.KERNELS_E2E_SCHEMA),
    },
}


def _load_baseline(path: str, baseline: str):
    if baseline != "git:HEAD":
        with open(baseline) as f:
            return json.load(f)
    out = subprocess.run(["git", "show", f"HEAD:{path}"], cwd=ROOT,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"no committed baseline for {path}: "
                         f"{out.stderr.strip()}")
    return json.loads(out.stdout)


def _shapes_match(spec, base_row, fresh_row) -> bool:
    return all(base_row.get(c) == fresh_row.get(c)
               for c in spec["shape_cols"])


def check(which: str, fresh_path: str, baseline: str, *,
          max_regression: float, subset: bool):
    """The problems of ``fresh_path`` against ``baseline`` (a file, or
    ``git:HEAD``), in the reference's order and words."""
    spec = SPECS[which]
    with open(fresh_path) as f:
        fresh_doc = json.load(f)
    base_doc = _load_baseline(spec["path"], baseline)
    fresh = {spec["key"](r): r for r in spec["rows"](fresh_doc)}
    base = {spec["key"](r): r for r in spec["rows"](base_doc)}
    if not fresh:
        return [f"{fresh_path}: no rows produced"]

    problems = []
    # schema gate: every fresh row must be a valid typed record; an
    # unknown or missing column fails before any timing comparison
    for key, frow in sorted(fresh.items(), key=str):
        for p in metrics.validate_bench_row(frow, spec["schema"](frow)):
            problems.append(f"{key}: {p}")
    if problems:
        return problems
    compared = 0
    for key, brow in sorted(base.items(), key=str):
        frow = fresh.get(key)
        if frow is None:
            if not subset:
                problems.append(f"{key}: row missing from fresh artifact")
            continue
        for col, bval in brow.items():
            if col not in frow:
                problems.append(f"{key}: column {col!r} missing")
                continue
            if bval is not None and frow[col] is None:
                problems.append(f"{key}: cell {col!r} went null "
                                f"(baseline {bval})")
        if not _shapes_match(spec, brow, frow):
            continue                      # different shape: structure only
        for col, lower_better in (
                [(c, False) for c in spec["throughput"]] +
                [(c, True) for c in spec["times"]]):
            bval, fval = brow.get(col), frow.get(col)
            if not (isinstance(bval, (int, float)) and
                    isinstance(fval, (int, float)) and bval > 0 and
                    fval > 0):
                continue
            tp_base, tp_fresh = ((1.0 / bval, 1.0 / fval)
                                 if lower_better else (bval, fval))
            regression = 1.0 - tp_fresh / tp_base
            compared += 1
            if regression > max_regression:
                problems.append(
                    f"{key}: {col} regressed {regression:.0%} "
                    f"(baseline {bval:.6g}, fresh {fval:.6g}, "
                    f"allowed {max_regression:.0%}; phases: "
                    f"{metrics.phase_breakdown(frow, spec['schema'](frow))})")
    print(f"# check_bench {which}: {len(base)} baseline rows, "
          f"{len(fresh)} fresh rows, {compared} timing cells compared")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", required=True, choices=sorted(SPECS))
    ap.add_argument("--fresh", default=None,
                    help="fresh artifact (default: the canonical output "
                         "path of the producing benchmark)")
    ap.add_argument("--baseline", default="git:HEAD",
                    help="baseline file, or git:HEAD for the committed "
                         "artifact (default)")
    ap.add_argument("--max-regression", type=float, default=0.25,
                    help="maximum tolerated throughput regression "
                         "(default 0.25 = 25%%)")
    ap.add_argument("--subset", action="store_true",
                    help="tolerate baseline rows absent from the fresh "
                         "artifact (smoke runs sweeping fewer shapes)")
    args = ap.parse_args(argv)
    fresh_path = args.fresh or os.path.join(ROOT, SPECS[args.which]["path"])
    problems = check(args.which, fresh_path, args.baseline,
                     max_regression=args.max_regression,
                     subset=args.subset)
    # shared formatter with the program-contract gate: plain
    # TAG file [rule] lines locally, ::error annotations in CI
    if emit([Finding(tag="REGRESSION", rule="BenchRegression",
                     message=p, file=fresh_path) for p in problems]):
        return 1
    print(f"# check_bench {args.which}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
