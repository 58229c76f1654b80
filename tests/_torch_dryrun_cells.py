"""Reduced cells of every architecture through the port's dry-run on a
fake 256-rank group, in a subprocess (the group must not outlive it):
each runs to its end and its record carries every key of the
reference's (``tests/test_torch_dryrun_cells_{a,b}.py``)."""
import json
import os
import subprocess
import sys

from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "status", "reason",
               "kind", "n_devices", "lower_s", "compile_s", "memory",
               "cost", "collectives", "cost_extrapolated",
               "model_flops_global"}

_RUN_CELLS = r"""
import json, sys
from repro_torch.configs import registry, shapes
from repro_torch.launch import dryrun
out = {}
for arch, shape_name in json.loads(sys.argv[1]):
    spec = registry.get(arch, reduced=True)
    # the reduced shape's sequence, a batch that splits over data=16
    red = shapes.REDUCED_SHAPES[shape_name]
    shape = shapes.Shape(shape_name, red.seq_len, 16, red.kind)
    out[f"{arch}|{shape_name}"] = dryrun.run_cell(
        arch, shape_name, "single", spec=spec, shape=shape, device="cpu")
print(json.dumps(out))
"""


def check_cells(cells):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", _RUN_CELLS,
                          json.dumps(cells)], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(recs) == len(cells)
    for cell, rec in recs.items():
        assert rec["status"] == "ok", (cell, rec)
        assert RECORD_KEYS <= set(rec), (cell, RECORD_KEYS - set(rec))
        assert rec["n_devices"] == 256
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "code_bytes"}
        assert set(rec["collectives"]["bytes"]) == set(dryrun.COLLECTIVES)
        assert rec["cost"]["flops"] > 0 and rec["memory"][
            "argument_bytes"] > 0
        assert rec["cost_extrapolated"]["repeats"] >= 1
