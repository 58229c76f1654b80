"""A two-rank gloo group's normal return, run many times: each pair of
``tests/_torch_teardown_check.py`` ranks (started by
``repro_torch.launch.variants.launch_group``) finishes a sharded run with
distributed checkpoints and returns from ``main`` without ``os._exit``,
leaving the group through the ``bootstrap.shutdown`` that ``bootstrap``
registers with ``atexit``, or through an explicit call of it. Every rank
must exit 0, and the hook must have run without an exception and left
the group (``EXIT-LEFT True``, printed by a hook that runs after it):
before the hook, a rank that left its group alive to the interpreter's
finalisation aborted now and then ("terminate called without an active
exception").
Pairs run three at a time, which also loads the CPU as the abort needed.
Imports no JAX."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import variants

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_teardown_check.py")
RUNS = 20
AT_ONCE = 3


def _pairs(tmp_path, leave, n):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DIALS_")}
    results = []
    for first in range(0, n, AT_ONCE):
        running = [variants.launch_group(
            [sys.executable, WORKER, "--leave", leave, "--ckpt-dir",
             str(tmp_path / f"{leave}{i}")], processes=2, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(first, min(n, first + AT_ONCE))]
        for procs in running:
            for rank, p in enumerate(procs):
                try:
                    out, _ = p.communicate(timeout=300)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                results.append((rank, p.returncode, out.decode()))
    return results


@pytest.mark.parametrize("leave,n", [("exit-hook", RUNS), ("shutdown", 4)])
def test_two_rank_group_returns_normally(tmp_path, leave, n):
    results = _pairs(tmp_path, leave, n)
    assert len(results) == 2 * n
    bad = [(rank, rc, out[-2000:]) for rank, rc, out in results
           if rc != 0 or f"TEARDOWN-DONE {rank}" not in out
           or "terminate called" in out
           or "Exception ignored" in out or "EXIT-LEFT True" not in out]
    assert not bad, f"{len(bad)} of {2 * n} rank exits failed: {bad[:2]}"
    for _, _, out in results:
        # only the main Python thread is alive at exit
        assert "EXIT-THREADS [('MainThread', False)]" in out
