"""Render the §Dry-run / §Roofline markdown tables from the port's dry-run
records — the port of ``benchmarks/report.py``, importing nothing of the
JAX package.

It reads ``experiments/dryrun_torch/*__{mesh}__{variant}.json`` under the
working directory (written by ``python -m repro_torch.launch.dryrun``;
each record holds one rank's numbers) and keeps the reference's functions
and table layout. The roofline terms come from
``benchmarks/torch_roofline.py`` with ``n_devices=1``: the H100's
datasheet constants, so every figure in the tables is the card's.

    python3 benchmarks/torch_report.py [--mesh single] \\
        [--what all|dryrun|roofline]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import torch_roofline  # noqa: E402

RECORDS = os.path.join("experiments", "dryrun_torch")
ARCH_ORDER = ["yi-34b", "gemma2-9b", "tinyllama-1.1b", "qwen1.5-32b",
              "zamba2-1.2b", "granite-moe-1b-a400m", "dbrx-132b",
              "whisper-tiny", "llama-3.2-vision-90b", "mamba2-780m"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt_s(x):
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x*1e3:.2f}ms"


def load(mesh: str, variant: str = "baseline"):
    recs = {}
    for fn in glob.glob(os.path.join(RECORDS, f"*__{mesh}__{variant}.json")):
        with open(fn) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    return recs


def roofline_row(rec):
    """The card's roofline terms of one record (``torch_roofline``'s, as
    ``torch_run.py --only roofline`` computes them) and MODEL/HLO flops.
    The port's dry-run writes ``cost_extrapolated`` equal to ``cost``, so
    the raw cost is what the reference's extrapolated one would be."""
    e = torch_roofline.per_device(rec)
    mf = rec.get("model_flops_global")
    ratio = (mf / rec["n_devices"] / e["flops"]) if mf else None
    return torch_roofline.terms(**e), ratio


def dryrun_table(mesh):
    recs = load(mesh)
    print(f"\n### Dry-run — {mesh} mesh "
          f"({'2x16x16=512' if mesh == 'multi' else '16x16=256'} chips)\n")
    print("| arch | shape | status | compile_s | temp GiB/dev |"
          " HLO GFLOPs/dev (scan-corrected) | collective GiB/dev |")
    print("|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None:
                continue
            if r["status"] != "ok":
                print(f"| {a} | {s} | SKIP — {r['reason']} | | | | |")
                continue
            e = r.get("cost_extrapolated", {})
            fl = e.get("flops", r["cost"]["flops"])
            cb = e.get("collective_bytes",
                       r["collectives"]["total_bytes"])
            print(f"| {a} | {s} | ok | {r['compile_s']} |"
                  f" {r['memory']['temp_bytes']/2**30:.2f} |"
                  f" {fl/1e9:,.0f} | {cb/2**30:.2f} |")


def roofline_table(mesh):
    recs = load(mesh)
    print(f"\n### Roofline — {mesh} mesh, per-device terms\n")
    print("| arch | shape | compute | memory | collective | bottleneck |"
          " MODEL/HLO flops | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None or r["status"] != "ok":
                continue
            t, ratio = roofline_row(r)
            print(f"| {a} | {s} | {_fmt_s(t['compute_s'])} |"
                  f" {_fmt_s(t['memory_s'])} |"
                  f" {_fmt_s(t['collective_s'])} | {t['bottleneck']} |"
                  f" {ratio:.3f} |" if ratio is not None else
                  f"| {a} | {s} | ... |", end="")
            print(f" {t['roofline_fraction']:.3f} |")


def variant_compare(arch, shape, mesh, variants):
    print(f"\n### {arch} × {shape} × {mesh} — variants\n")
    print("| variant | compute | memory | collective | bottleneck |")
    print("|---|---|---|---|---|")
    for v in variants:
        try:
            with open(os.path.join(
                    RECORDS, f"{arch}__{shape}__{mesh}__{v}.json")) as f:
                r = json.load(f)
        except FileNotFoundError:
            continue
        if r["status"] != "ok":
            continue
        t, _ = roofline_row(r)
        print(f"| {v} | {_fmt_s(t['compute_s'])} | {_fmt_s(t['memory_s'])} |"
              f" {_fmt_s(t['collective_s'])} | {t['bottleneck']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--what", default="all",
                    choices=["all", "dryrun", "roofline"])
    args = ap.parse_args(argv)
    if args.what in ("all", "dryrun"):
        dryrun_table(args.mesh)
    if args.what in ("all", "roofline"):
        roofline_table(args.mesh)


if __name__ == "__main__":
    main()
