"""The port's post-loss re-bootstrap pieces (``repro_torch.distributed.
recovery``, ``bootstrap``, ``coordinator``) with test doubles, against
the reference where it has the same function: ``shrink_config``,
``reexec``'s env contract, ``bootstrap_with_retry``, ``raising_gate``,
``diagnose`` on the errors gloo really raises (a killed and a stalled
peer of a live two-rank group, ``tests/_torch_peer_check.py``), the
``Deadman`` watchdog, ``recover`` end to end with doubles, the group
timeout of ``grace_kwargs`` and the coordinator CLI."""
import datetime
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

import _torch_procs as procs
from repro.distributed import bootstrap as jboot
from repro.distributed import recovery as jrec
from repro_torch.distributed import bootstrap, recovery

PEER = os.path.join(procs.ROOT, "tests", "_torch_peer_check.py")
# what gloo raised in a live group on the CPU (torch 2.13): a SIGKILLed
# peer, then a peer that stopped taking part past the group's timeout
GLOO_TEXTS = [
    "RuntimeError: [../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
    "Connection closed by peer [127.0.0.1]:32672. This is typically caused "
    "by a remote worker crashing. Check the logs of the remote worker "
    "before reporting an error.",
    "RuntimeError: [../third_party/gloo/gloo/transport/tcp/"
    "unbound_buffer.cc:78] Timed out waiting 3000ms for recv operation to "
    "complete",
    "RuntimeError: Application timeout caused pair closure",
]


class _Rec:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})

    def close(self):
        pass


def _cfg(n=2, pid=0, port=5000, mod=bootstrap):
    return mod.BootstrapConfig(coordinator=f"127.0.0.1:{port}",
                               num_processes=n, process_id=pid)


def test_shrink_config_matches_reference():
    for n in (2, 3, 5):
        for pid in range(n):
            for dead in ([0], [n - 1], [0, n - 1], list(range(1, n))):
                for gen, stride in ((1, 17), (2, 10)):
                    def fields(mod, rec):
                        try:
                            c = rec.shrink_config(
                                _cfg(n, pid, mod=mod), dead, gen,
                                port_stride=stride)
                        except ValueError as e:
                            return str(e)
                        return None if c is None else (
                            c.coordinator, c.num_processes, c.process_id)
                    assert fields(bootstrap, recovery) == \
                        fields(jboot, jrec)


def test_reexec_env_contract():
    env = {"DIALS_COORDINATOR": "127.0.0.1:5000",
           "DIALS_NUM_PROCESSES": "2", "DIALS_PROCESS_ID": "1",
           "DIALS_COORDINATOR_EXTERNAL": "1", "OTHER": "kept"}
    execs = []
    recovery.reexec(None, 1, environ=env, argv=["tests/x.py", "--f"],
                    execv=lambda p, a: execs.append((p, a)))
    assert env == {"OTHER": "kept", "DIALS_RECOVERY_GENERATION": "1"}
    assert execs == [(sys.executable,
                      [sys.executable, "tests/x.py", "--f"])]
    env2 = {"DIALS_PROCESS_ID": "2"}
    recovery.reexec(_cfg(2, 1, port=5017), 2, environ=env2, argv=["x"],
                    execv=lambda p, a: None)
    assert env2 == {"DIALS_COORDINATOR": "127.0.0.1:5017",
                    "DIALS_NUM_PROCESSES": "2", "DIALS_PROCESS_ID": "1",
                    "DIALS_RECOVERY_GENERATION": "2"}
    assert recovery.generation({}) == 0
    assert recovery.generation({"DIALS_RECOVERY_GENERATION": "2"}) == 2


def test_bootstrap_with_retry_backs_off_and_gives_up():
    calls, slept = [], []
    sentinel = object()

    def flaky(cfg, init_timeout_s=None, peer_death_grace_s=None):
        calls.append((init_timeout_s, peer_death_grace_s))
        if len(calls) < 3:
            raise RuntimeError("coordinator not up yet")
        return sentinel

    rec = _Rec()
    ctx, attempts = recovery.bootstrap_with_retry(
        _cfg(), reco=recovery.RecoveryConfig(init_timeout_s=7.0,
                                             peer_death_grace_s=300.0),
        telemetry=rec, sleep=slept.append, _bootstrap=flaky)
    assert ctx is sentinel and attempts == 3
    assert calls == [(7.0, 300.0)] * 3 and slept == [0.5, 1.0]
    assert [e["event"] for e in rec.events] == ["bootstrap_retry"] * 2

    def never(cfg, **kw):
        raise OSError("bind failed")

    slept.clear()
    with pytest.raises(OSError, match="bind failed"):
        recovery.bootstrap_with_retry(
            _cfg(), reco=recovery.RecoveryConfig(retries=2),
            sleep=slept.append, _bootstrap=never)
    assert slept == [0.5, 1.0]


class _StubGate:
    def __init__(self, dead, last_round=4):
        self.round = last_round
        self.monitor = object()
        self.calls = []
        self._dead = dead

    def __call__(self, rnd):
        self.calls.append(rnd)
        if self._dead:
            raise recovery.HostLossDetected(rnd, self._dead)
        return ()


@pytest.mark.parametrize("mode", ["kill", "stall"])
def test_diagnose_reads_what_gloo_raises(mode):
    """A live two-rank group on the CPU broken by a killed or a stalled
    peer: the error rank 0 gets reads as a peer failure, and diagnose()
    turns it into the monitor's verdict."""
    (rc0, log0), (rc1, _) = procs.wait_all(procs.launch(
        PEER, ["--mode", mode]), timeout=120)
    assert rc0 == 0, log0[-2000:]
    assert rc1 == (-9 if mode == "kill" else 0)
    line = [x for x in log0.splitlines() if x.startswith("PEER-ERROR")]
    assert line and line[0] != "PEER-ERROR none", log0[-2000:]
    assert "PEER-FAILURE True" in log0, log0[-2000:]
    err = RuntimeError(line[0][len("PEER-ERROR "):])
    gate, rec = _StubGate(dead=(1,)), _Rec()
    loss = recovery.diagnose(err, gate, telemetry=rec)
    assert gate.calls == [5] and (loss.round, loss.dead) == (5, (1,))
    assert [e["event"] for e in rec.events] == ["collective_failure"]


def test_peer_failure_markers_and_diagnose_rules():
    for text in GLOO_TEXTS:
        assert recovery.is_peer_failure(RuntimeError(text)), text
    for err in (ValueError("shape mismatch"), ZeroDivisionError("x"),
                RuntimeError("CUDA error: an illegal memory access")):
        assert not recovery.is_peer_failure(err)
    loss = recovery.HostLossDetected(3, (1,))
    assert recovery.diagnose(loss, None) is loss
    gate = _StubGate(dead=(1,))
    with pytest.raises(ValueError, match="shape"):
        recovery.diagnose(ValueError("shape mismatch"), gate)
    assert gate.calls == []
    alive = _StubGate(dead=())
    with pytest.raises(RuntimeError, match="Connection closed"):
        recovery.diagnose(RuntimeError(GLOO_TEXTS[0]), alive)
    assert alive.calls == [5]
    with pytest.raises(RuntimeError, match="Connection closed"):
        recovery.diagnose(RuntimeError(GLOO_TEXTS[0]), None)

    class Mon:
        def __init__(self, dead):
            self._dead = dead

        def gate(self, rnd):
            return self._dead

    g = recovery.raising_gate(Mon(()))
    assert g(3) == () and g.round == 3
    with pytest.raises(recovery.HostLossDetected) as ei:
        recovery.raising_gate(Mon((1, 0)))(4)
    assert ei.value.round == 4 and ei.value.dead == (0, 1)


def _touch(path, age_s=0.0):
    with open(path, "w") as f:
        f.write("x")
    if age_s:
        t = time.time() - age_s
        os.utime(path, (t, t))


def test_deadman_watches_and_claims(tmp_path):
    d = recovery.Deadman(str(tmp_path), host=0, n_hosts=3,
                         on_loss=lambda loss: None, silence_s=5.0)
    d._born = time.time() - 120.0
    _touch(str(tmp_path / "live-1"), age_s=60.0)
    assert d.silent_peers() == (1,)       # peer 2 never pulsed: booting
    _touch(str(tmp_path / "live-1"))
    assert d.silent_peers() == ()
    fired, rec = [], _Rec()
    w = recovery.Deadman(str(tmp_path / "w"), host=0, n_hosts=2,
                         on_loss=fired.append, current_round=lambda: 7,
                         interval_s=0.02, silence_s=0.2, telemetry=rec)
    _touch(str(tmp_path / "w" / "live-1"))
    w.start()
    deadline = time.time() + 10.0
    while not fired and time.time() < deadline:
        time.sleep(0.02)
    w.stop()
    assert fired and fired[0].dead == (1,) and fired[0].round == 7
    assert os.path.exists(tmp_path / "w" / "live-0")
    assert [e["detector"] for e in rec.events
            if e["event"] == "host_death"] == ["deadman"]
    assert not w.claim()


def test_recover_flow_with_doubles(tmp_path):
    env = {"DIALS_RECOVERY_GENERATION": "0", "DIALS_PROCESS_ID": "1",
           "DIALS_COORDINATOR": "127.0.0.1:5000",
           "DIALS_NUM_PROCESSES": "3"}
    rec, execs = _Rec(), []
    ctx = bootstrap.DistContext(process_id=1, num_processes=3,
                                coordinator="127.0.0.1:5000",
                                initialized=False)
    recovery.recover(
        recovery.HostLossDetected(2, (0,)), ctx,
        ckpt_dir=str(tmp_path / "ck"), environ=env, telemetry=rec,
        execv=lambda p, a: execs.append((p, a)))
    assert [e["event"] for e in rec.events] == [
        "recovery_begin", "recovery_finalize", "recovery_exec"]
    assert rec.events[1]["step"] is None and rec.events[1]["latest"] == -1
    assert rec.events[2]["num_processes"] == 2
    # the coordinator moved to the lowest survivor, on a bumped port
    assert env["DIALS_COORDINATOR"] == "127.0.0.1:5017"
    assert (env["DIALS_PROCESS_ID"], env["DIALS_NUM_PROCESSES"],
            env["DIALS_RECOVERY_GENERATION"]) == ("0", "2", "1")
    assert len(execs) == 1


def test_grace_and_external_coordinator_config():
    assert bootstrap.grace_kwargs(7.5) == {
        "timeout": datetime.timedelta(seconds=7.5)}
    assert recovery.RecoveryConfig().peer_death_grace_s == \
        jrec.RecoveryConfig().peer_death_grace_s
    assert bootstrap.external_coordinator({"DIALS_COORDINATOR_EXTERNAL":
                                           "1"})
    assert not bootstrap.external_coordinator(
        {"DIALS_COORDINATOR_EXTERNAL": "0"})
    env = {"DIALS_COORDINATOR": "127.0.0.1:5", "DIALS_NUM_PROCESSES": "2",
           "DIALS_PROCESS_ID": "1", "DIALS_COORDINATOR_EXTERNAL": "1"}
    assert bootstrap.config_from_env(env) == _cfg(2, 1, port=5)


def test_coordinator_cli_comes_up_and_exits(tmp_path):
    ready = str(tmp_path / "coord.ready")
    port = procs.free_port()
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.distributed.coordinator",
         "--bind", f"127.0.0.1:{port}", "--num-processes", "1",
         "--ready-file", ready, "--timeout-s", "1"],
        cwd=procs.ROOT, env=procs.env(), capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert open(ready).read() == f"127.0.0.1:{port}"
    assert time.monotonic() - t0 < 30
