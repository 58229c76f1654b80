"""Post-loss re-bootstrap: survive a host death by restarting the
process group, not only by shrinking the mesh — the port of
``repro/distributed/recovery.py``.

The in-process elastic path (``DIALSTrainer.run(heartbeats=...)``) keeps
training on a mesh the survivor owns alone; with more than one survivor
it cannot shrink the old group, whose dead members every new group needs
(``runtime.survivor_mesh``). The recovery path restarts instead, under
three constraints it shares with the reference:

1. Leaving a group next to a dead peer may hang, so :func:`teardown`
   runs ``torch.distributed.destroy_process_group`` on a daemon thread
   with a bounded join and abandons it on timeout.
2. The surviving process re-executes itself (``os.execv``) with the
   shrunken group's ``DIALS_*`` env, and the fresh interpreter
   bootstraps normally. That needs a real script: a ``spawn``-started
   child (``bootstrap.spawn_local``) has ``-c ...`` for its argv.
3. The dying group's collectives are unusable, so survivor state is not
   moved over the group; it comes from the last committed distributed
   checkpoint, including a commit takeover (:meth:`~repro_torch.
   checkpoint.distributed.DistributedCheckpointManager.finalize_pending`)
   when rank 0 died between prepare and commit.

Flow: the driver's ``heartbeats`` hook raises :class:`HostLossDetected`
out of ``DIALSTrainer.run`` (:func:`raising_gate`); the worker's
``except`` arm calls :func:`recover`: finalize a pending commit, a
bounded teardown, :func:`shrink_config` (survivors re-ranked, the
coordinator moved to the lowest surviving rank on a port bumped by the
generation), :func:`reexec`. The re-executed process sees
``DIALS_RECOVERY_GENERATION`` >= 1, bootstraps through
:func:`bootstrap_with_retry` (bounded retries, exponential backoff, a
short wait for the peers), emits ``rebootstrap`` and resumes ``run()``
from the committed checkpoint.

A group's timeout is its grace window (``RecoveryConfig.
peer_death_grace_s``, ``bootstrap.grace_kwargs``): gloo fails a
collective with a dead peer at once ("Connection closed by peer") and
one with a stalled peer after the timeout; :func:`diagnose` turns either
into a verdict of the heartbeat monitor.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.distributed import bootstrap

ENV_GENERATION = "DIALS_RECOVERY_GENERATION"


class HostLossDetected(RuntimeError):
    """Raised out of the driver's heartbeat gate when the HostMonitor
    declares peers dead — carries what the supervisor needs."""

    def __init__(self, round: int, dead: Sequence[int]):
        super().__init__(f"host(s) {sorted(dead)} lost at round {round}")
        self.round = int(round)
        self.dead = tuple(sorted(dead))


def raising_gate(monitor):
    """A ``heartbeats`` callback for ``DIALSTrainer.run`` that converts
    a death verdict into :class:`HostLossDetected` instead of handing
    back a shrunken remnant mesh — the re-bootstrap path's entry.
    Remembers the last gated round (``gate.round``) and its monitor
    (``gate.monitor``) so :func:`diagnose` can hold a post-mortem after
    a mid-round collective failure."""
    def gate(rnd: int):
        gate.round = max(gate.round, rnd)
        dead = monitor.gate(rnd)
        if dead:
            raise HostLossDetected(rnd, dead)
        return ()
    gate.round = 0
    gate.monitor = monitor
    return gate


_PEER_FAILURE_MARKERS = (
    # gloo's transport errors (torch.distributed raises them as
    # RuntimeError or DistBackendError) when a dead peer's TCP
    # connection drops mid-collective
    "connection closed by peer",
    "remote worker crashing",
    "connection reset by peer",
    "connection refused",
    "socket closed",
    "broken pipe",
    # a stalled peer: the group's timeout, then the pairs it closed
    "timed out waiting",
    "application timeout caused pair closure",
    # the c10d error classes themselves
    "distbackenderror",
    "diststoreerror",
    "distnetworkerror",
)


def is_peer_failure(err: BaseException) -> bool:
    """Does this error read like a dead peer rather than a program bug?
    Marker matching: gloo surfaces a broken pair as a plain
    ``RuntimeError`` (or ``DistBackendError``) whose text names the
    cause."""
    text = f"{type(err).__name__}: {err}".lower()
    return any(m in text for m in _PEER_FAILURE_MARKERS)


def diagnose(err: BaseException, gate, *, telemetry=obs.DISABLED
             ) -> HostLossDetected:
    """Post-mortem for an exception that escaped the training loop: a
    host death *between* rounds raises :class:`HostLossDetected` at the
    gate, but a death *mid-round* surfaces first as a failed collective
    (gloo's "Connection closed by peer") — the gate
    never ran. When the error reads like a peer failure, ask the
    heartbeat monitor for the verdict: every survivor runs this same
    protocol and beats ``gate.round + 1``, while the dead peer never
    will. Returns the loss to hand to :func:`recover`; re-raises ``err``
    when it isn't a peer failure or every peer turns out to be alive
    (a real program error must stay fatal)."""
    if isinstance(err, HostLossDetected):
        return err
    if gate is None or getattr(gate, "monitor", None) is None \
            or not is_peer_failure(err):
        raise err
    rnd = gate.round + 1
    telemetry.emit("collective_failure", round=rnd - 1,
                   error=repr(err)[:500])
    try:
        gate(rnd)
    except HostLossDetected as loss:
        return loss
    raise err                        # everyone beat: not a host loss


class Deadman:
    """Liveness watchdog for the deaths the round protocol cannot see.

    Both in-band detectors need the MAIN thread back in Python: the
    heartbeat gate runs between rounds, and :func:`diagnose` runs after
    a collective *errors*. But a peer that dies mid-collective can
    leave the survivor wedged in a native wait that does not error
    before the group's timeout (the recv side of a half-open TCP
    connection sees no RST). The deadman is the out-of-band answer:

    * a **pulse** thread touches ``live-{host}`` in the shared beat
      directory every ``interval_s``, independent of round progress
      (native collectives release the GIL, so the pulse keeps running
      while the main thread is stuck);
    * a **watch** thread declares any peer whose pulse has been silent
      for ``silence_s`` dead and hands a :class:`HostLossDetected` to
      ``on_loss`` — typically a closure over :func:`recover`, which is
      safe to run from this thread because ``os.execv`` replaces the
      whole process, wedged threads included.

    ``silence_s`` must sit between the longest legitimate pulse gap
    (scheduler jitter, seconds) and the bootstrap's
    ``peer_death_grace_s`` (the group's timeout). The
    :meth:`claim` latch keeps the watchdog and a healthy main-thread
    recovery path from both acting: whoever claims first recovers, the
    other parks. Staleness is judged by file mtime, so all hosts must
    share a filesystem clock (same box, or NFS with sane time sync) —
    the same assumption ``HostMonitor`` already makes.
    """

    def __init__(self, directory: str, *, host: int, n_hosts: int,
                 on_loss, current_round=lambda: 0,
                 interval_s: float = 2.0, silence_s: float = 60.0,
                 telemetry=obs.DISABLED):
        self.directory = directory
        self.host = int(host)
        self.n_hosts = int(n_hosts)
        self.on_loss = on_loss
        self.current_round = current_round
        self.interval_s = float(interval_s)
        self.silence_s = float(silence_s)
        self.telemetry = telemetry
        self._stop = threading.Event()
        self._latch = threading.Lock()
        self._threads = []
        self._born = time.time()
        os.makedirs(directory, exist_ok=True)

    def _live_path(self, host: int) -> str:
        return os.path.join(self.directory, f"live-{host}")

    def _pulse(self) -> None:
        path = self._live_path(self.host)
        while not self._stop.is_set():
            with open(path, "w") as f:
                f.write(str(time.time()))
            self._stop.wait(self.interval_s)

    def silent_peers(self) -> Tuple[int, ...]:
        """Peers whose pulse is ``silence_s`` stale. A peer that never
        pulsed SINCE THIS WATCHDOG WAS BORN is not silent: either it is
        still bootstrapping (the init timeout's failure mode, not ours)
        or the file is a leftover from a previous generation — the beat
        directory survives execv, and re-ranked host ids alias old
        ones."""
        now = time.time()
        dead = []
        for h in range(self.n_hosts):
            if h == self.host:
                continue
            try:
                mtime = os.stat(self._live_path(h)).st_mtime
            except OSError:
                continue
            if mtime >= self._born and now - mtime > self.silence_s:
                dead.append(h)
        return tuple(dead)

    def _watch(self) -> None:
        while not self._stop.wait(self.interval_s):
            dead = self.silent_peers()
            if not dead or not self.claim():
                continue
            rnd = int(self.current_round())
            self.telemetry.emit("host_death", round=rnd,
                                dead_hosts=list(dead),
                                all_dead=list(dead),
                                detector="deadman",
                                silence_s=self.silence_s)
            self.on_loss(HostLossDetected(rnd, dead))
            return

    def claim(self) -> bool:
        """Non-blocking recovery latch, shared with the main-thread
        path: True exactly once. A loser must not start its own
        recovery — the winner is about to exec the process away."""
        return self._latch.acquire(blocking=False)

    def start(self) -> "Deadman":
        self._threads = [
            threading.Thread(target=self._pulse, daemon=True,
                             name="deadman-pulse"),
            threading.Thread(target=self._watch, daemon=True,
                             name="deadman-watch")]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Stop pulsing AND watching — call the moment the run loop
        returns, BEFORE teardown: a peer that finished and exited is
        silent, not dead."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)


def generation(environ: Mapping[str, str] = os.environ) -> int:
    """Which recovery incarnation this process is (0 = original launch)."""
    return int(environ.get(ENV_GENERATION, "0") or "0")


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Knobs for the supervisor; defaults sized for CI subprocess runs.

    ``peer_death_grace_s`` is the group's timeout at bootstrap (see
    :func:`bootstrap.grace_kwargs`): how long a collective with a
    stalled peer blocks before it fails. gloo's default is 30 minutes,
    which would hold the survivor that long inside a collective the
    dead peer never joins."""
    teardown_timeout_s: float = 5.0
    init_timeout_s: float = 60.0
    retries: int = 3
    backoff_s: float = 0.5
    backoff_max_s: float = 8.0
    port_stride: int = 17            # coordinator port bump per generation
    peer_death_grace_s: float = 600.0


def teardown(timeout_s: float = 5.0, *, telemetry=obs.DISABLED) -> bool:
    """Best-effort ``torch.distributed.destroy_process_group`` that
    cannot wedge the survivor: next to a dead peer it may block, so it
    runs on a daemon thread and is abandoned after ``timeout_s`` (the
    process is about to exec away anyway). Returns True iff it
    completed."""
    def _shutdown():
        try:
            # no barrier: the peer it would wait for is dead
            bootstrap.shutdown(barrier_timeout_s=None)
        except Exception:            # noqa: BLE001 - already dying
            pass

    t = threading.Thread(target=_shutdown, daemon=True)
    t.start()
    t.join(timeout_s)
    ok = not t.is_alive()
    telemetry.emit("recovery_teardown", ok=ok, timeout_s=timeout_s)
    return ok


def shrink_config(cfg: bootstrap.BootstrapConfig, dead: Sequence[int],
                  new_generation: int, *, port_stride: int = 17
                  ) -> Optional[bootstrap.BootstrapConfig]:
    """The shrunken group's contract after ``dead`` ranks are removed:
    survivors re-rank in order, the new rank 0 (coordinator failover —
    the old coordinator host may be among the dead) serves on the old
    port bumped by ``new_generation * port_stride`` so a half-dead old
    store can't collide with the new one. None when one
    process survives — a solo run needs no coordinator at all."""
    dead_set = set(dead)
    survivors = [p for p in range(cfg.num_processes) if p not in dead_set]
    if cfg.process_id not in survivors:
        raise ValueError(f"process {cfg.process_id} is among the dead")
    if len(survivors) <= 1:
        return None
    host, _, port = cfg.coordinator.rpartition(":")
    new_port = int(port) + new_generation * port_stride
    return bootstrap.BootstrapConfig(
        coordinator=f"{host}:{new_port}",
        num_processes=len(survivors),
        process_id=survivors.index(cfg.process_id),
        local_devices=cfg.local_devices)


def reexec(cfg: Optional[bootstrap.BootstrapConfig], new_generation: int, *,
           environ=os.environ, argv: Optional[Sequence[str]] = None,
           execv=os.execv) -> None:
    """Replace this process with a fresh interpreter carrying the
    shrunken group's env: the new group starts in a clean process, with
    none of the old group's threads or sockets. ``cfg=None`` clears the
    group declaration (solo resume)."""
    for k in (bootstrap.ENV_COORDINATOR, bootstrap.ENV_NUM_PROCESSES,
              bootstrap.ENV_PROCESS_ID, bootstrap.ENV_COORDINATOR_EXTERNAL):
        environ.pop(k, None)
    if cfg is not None:
        environ.update(cfg.env())
    environ[ENV_GENERATION] = str(new_generation)
    args = list(argv if argv is not None else sys.argv)
    execv(sys.executable, [sys.executable] + args)


def bootstrap_with_retry(cfg: Optional[bootstrap.BootstrapConfig], *,
                         reco: RecoveryConfig = RecoveryConfig(),
                         telemetry=obs.DISABLED, sleep=time.sleep,
                         _bootstrap=bootstrap.bootstrap
                         ) -> Tuple[bootstrap.DistContext, int]:
    """``bootstrap()`` under bounded retry with exponential backoff —
    surviving peers of a shrunken group re-exec at slightly different
    times, so the first initialize attempts can race the new
    coordinator's socket. Returns ``(ctx, attempts_used)``; re-raises
    the last error once retries are exhausted."""
    last: Optional[BaseException] = None
    for attempt in range(reco.retries + 1):
        try:
            ctx = _bootstrap(cfg, init_timeout_s=reco.init_timeout_s,
                             peer_death_grace_s=reco.peer_death_grace_s)
            return ctx, attempt + 1
        except (RuntimeError, OSError, ValueError) as e:
            last = e
            telemetry.emit("bootstrap_retry", attempt=attempt,
                           error=repr(e))
            if attempt < reco.retries:
                sleep(min(reco.backoff_s * (2 ** attempt),
                          reco.backoff_max_s))
    raise last  # type: ignore[misc]


def startup(environ: Mapping[str, str] = os.environ, *,
            reco: RecoveryConfig = RecoveryConfig(),
            telemetry=obs.DISABLED) -> Tuple[bootstrap.DistContext, int]:
    """Worker-side entry: bootstrap (with retry when this is a recovery
    incarnation) and announce the rebootstrap in telemetry. Returns
    ``(ctx, generation)``."""
    gen = generation(environ)
    cfg = bootstrap.config_from_env(environ)
    if gen == 0:
        return bootstrap.bootstrap(
            cfg, peer_death_grace_s=reco.peer_death_grace_s), 0
    ctx, attempts = bootstrap_with_retry(cfg, reco=reco, telemetry=telemetry)
    telemetry.emit("rebootstrap", generation=gen, attempts=attempts,
                   num_processes=ctx.num_processes,
                   process_id=ctx.process_id)
    return ctx, gen


def recover(loss: HostLossDetected, ctx: bootstrap.DistContext, *,
            ckpt_dir: Optional[str] = None,
            cfg: Optional[bootstrap.BootstrapConfig] = None,
            reco: RecoveryConfig = RecoveryConfig(),
            environ=os.environ, telemetry=obs.DISABLED,
            execv=os.execv) -> None:
    """The supervisor: turn a detected host loss into a resumed run.
    Does not return (the process execs away) unless ``execv`` is a test
    double."""
    gen = generation(environ) + 1
    telemetry.emit("recovery_begin", round=loss.round,
                   dead=list(loss.dead), generation=gen)
    if ckpt_dir:
        from repro_torch.checkpoint.distributed import (
            DistributedCheckpointManager)
        mgr = DistributedCheckpointManager(
            ckpt_dir, process_id=ctx.process_id, telemetry=telemetry)
        finalized = mgr.finalize_pending()
        telemetry.emit("recovery_finalize", step=finalized,
                       latest=mgr.latest_committed())
    if ctx.initialized and reco.teardown_timeout_s > 0:
        # best-effort only, and on a clock: leaving a group next to a
        # dead peer may block, and the survivor must exec away. <= 0
        # skips teardown.
        teardown(reco.teardown_timeout_s, telemetry=telemetry)
    if cfg is None:
        cfg = bootstrap.config_from_env(environ)
    new_cfg = None
    if cfg is not None:
        new_cfg = shrink_config(cfg, loss.dead, gen,
                                port_stride=reco.port_stride)
    telemetry.emit("recovery_exec", generation=gen,
                   num_processes=new_cfg.num_processes if new_cfg else 1)
    telemetry.close()
    reexec(new_cfg, gen, environ=environ, execv=execv)
