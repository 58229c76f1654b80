"""Launch helpers for the port's multi-process end-to-end tests: ranks of
one gloo group as ``subprocess.Popen`` workers under the ``DIALS_*``
env contract (``repro_torch.distributed.bootstrap``), and the external
coordinator (``python -m repro_torch.distributed.coordinator``).
``bootstrap.spawn_local`` is not used for these: it reports a rank that
dies as a failure, and a re-exec needs a real script. Imports no JAX."""
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIHOST = os.path.join(ROOT, "tests", "_torch_multihost_check.py")
RECOVERY = os.path.join(ROOT, "tests", "_torch_recovery_check.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env(*, port=None, rank=0, n=2, external=False):
    out = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    for k in ("DIALS_RECOVERY_GENERATION", "DIALS_COORDINATOR_EXTERNAL",
              "DIALS_COORDINATOR", "DIALS_NUM_PROCESSES",
              "DIALS_PROCESS_ID", "DIALS_LOCAL_DEVICES"):
        out.pop(k, None)
    if port is not None:
        out.update({"DIALS_COORDINATOR": f"127.0.0.1:{port}",
                    "DIALS_NUM_PROCESSES": str(n),
                    "DIALS_PROCESS_ID": str(rank)})
        if external:
            out["DIALS_COORDINATOR_EXTERNAL"] = "1"
    return out


def launch(script, args, *, n=2, port=None, external=False):
    """``n`` ranks of ``script args`` on one group at ``port``."""
    port = port if port is not None else free_port()
    return [subprocess.Popen(
        [sys.executable, script, *args], cwd=ROOT,
        env=env(port=port, rank=r, n=n, external=external),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def wait_all(procs, timeout=300):
    """``[(returncode, output)]`` by rank; a rank still running at the
    deadline is killed."""
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\n[killed at the test's deadline]"
        out.append((p.returncode, text))
    return out


def start_coordinator(tmp_path, n=2, timeout_s=600):
    """The external coordinator on a free port; returns (proc, port)
    once its ready file exists."""
    port = free_port()
    ready = os.path.join(str(tmp_path), "coordinator.ready")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.coordinator",
         "--bind", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--ready-file", ready, "--timeout-s", str(timeout_s)],
        cwd=ROOT, env=env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    for _ in range(1200):
        if os.path.exists(ready) or proc.poll() is not None:
            break
        time.sleep(0.05)
    assert os.path.exists(ready), "the external coordinator never came up"
    return proc, port


def stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def recovery_scenario(tmp_path, spec, *, dead_rank, resume_rounds):
    """Run ``tests/_torch_recovery_check.py`` on two ranks around the
    external coordinator under the chaos ``spec`` and hold the outcome
    to the recovery contract: the doomed rank SIGKILLed, the survivor
    re-executed as a solo generation 1 resuming ``resume_rounds``, its
    final state bit for bit a loop run resumed in this process from the
    same committed step, within the port's two-rank tolerances (AIPs and
    policy 1e-6) of the uninterrupted run, and the merged event log
    passing ``tools/telemetry_report.py --check --expect-recovery``.
    Returns the merged events."""
    import shutil

    import torch
    from repro_torch import random as R
    from repro_torch.analysis import programs
    from repro_torch.tree import leaves
    from tools import telemetry_report

    out, ck = str(tmp_path / "got.pt"), str(tmp_path / "ck")
    tel = str(tmp_path / "tel")
    coordinator, port = start_coordinator(tmp_path)
    try:
        ranks = launch(RECOVERY, [
            "--out", out, "--beat-dir", str(tmp_path / "beats"),
            "--ckpt-dir", ck, "--telemetry-dir", tel, "--chaos", spec],
            port=port, external=True)
        results = wait_all(ranks, timeout=240)
    finally:
        stop(coordinator)
    rc_dead, log_dead = results[dead_rank]
    rc_live, log_live = results[1 - dead_rank]
    assert rc_dead == -9, f"rc={rc_dead}\n{log_dead[-3000:]}"
    # the Popen handle followed the survivor through os.execv (same
    # pid): its code and output are generation 1's
    assert rc_live == 0 and "RECOVERY-OK" in log_live, log_live[-5000:]

    got = torch.load(out, weights_only=False)
    assert (got["generation"], got["world"]) == (1, 1)
    assert [r["round"] for r in got["history"]] == resume_rounds
    assert all(r["n_shards"] == 1 for r in got["history"])

    def state_leaves(tree):
        return leaves(tree["aips"]) + leaves(tree["ials"])

    # a loop run resumed here from the step the survivor resumed from
    first = resume_rounds[0]
    one = str(tmp_path / "one")
    os.makedirs(one)
    shutil.copytree(os.path.join(ck, f"step_{first}"),
                    os.path.join(one, f"step_{first}"))
    resumed, hist = programs.tiny_trainer(
        "traffic", device="cpu", outer_rounds=len(resume_rounds) + first,
        ckpt_dir=one).run(R.key(0))
    assert [r["round"] for r in hist] == resume_rounds
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(got),
                                                 state_leaves(resumed)))
    straight, _ = programs.tiny_trainer(
        "traffic", device="cpu",
        outer_rounds=len(resume_rounds) + first).run(R.key(0))
    for a, b in zip(state_leaves(got), state_leaves(straight)):
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 1e-6
        else:
            assert torch.equal(a, b)

    events = telemetry_report.load_events(tel)
    assert telemetry_report.check(events) == [], \
        telemetry_report.check(events)
    assert telemetry_report.check_recovery(events) == [], \
        telemetry_report.check_recovery(events)
    assert telemetry_report.main([tel, "--check", "--expect-recovery"]) == 0
    injected = [e for e in events if e["event"] == "chaos_inject"]
    assert any(e["kind"] == "writer_crash" and e["host"] == dead_rank
               for e in injected), injected
    death = [e for e in events if e["event"] == "host_death"]
    assert death and death[0]["dead_hosts"] == [dead_rank], death
    reboot = [e for e in events if e["event"] == "rebootstrap"]
    assert reboot and (reboot[0]["generation"],
                       reboot[0]["num_processes"]) == (1, 1), reboot
    return events
