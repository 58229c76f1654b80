"""Deterministic fault injection for the distributed runtime — the port of
``repro/distributed/chaos.py`` (pure Python; the same events for the same
spec or seed).

A :class:`FaultSchedule` is an explicit, seedable list of
:class:`FaultEvent`\\ s injected through three hook surfaces the runtime
already exposes:

* ``round_start(rnd)`` — called by both DIALS drivers at the top of each
  outer round (``DIALSTrainer.run(..., chaos=...)``): ``host_kill``
  SIGKILLs the targeted host at the round boundary (the only point where
  a peer death cannot strand survivors inside a collective),
  ``interrupt`` raises :class:`ChaosInterrupt` for in-process
  kill-and-resume tests.
* ``checkpoint_phase(step, phase, directory)`` — installed as
  ``CheckpointManager.hooks``: ``writer_crash`` dies (SIGKILL, or raises
  :class:`ChaosError` in ``mode=raise``) at a chosen write phase
  (``write_begin`` → ``leaves_written`` → ``prepared`` → ``pre_commit``
  → ``committed``), ``commit_delay`` stretches the prepare→commit window
  so a host kill lands between the two phases, and ``corrupt`` flips
  bytes in a just-committed step.
* ``heartbeat(rnd)`` — called by ``fault.HostMonitor.beat``:
  ``heartbeat_delay`` sleeps before beating, simulating a straggler.

Every injection emits a ``chaos_inject`` telemetry event *before*
acting (the JSONL sink flushes per line, so even a SIGKILL leaves its
cause in the merged log). Schedules come from an explicit event list,
the compact ``from_spec`` string used by tests/CI
(``"kill@2:host=1,corrupt@3:target=bytes"``), or ``seeded`` — a
``random.Random(seed)`` draw, so a CI chaos matrix is reproducible from
its seed alone. Events fire at most once and are filtered by the host's
identity and the recovery ``generation`` (a fault scheduled for
generation 0 must not re-fire after the survivor re-execs as
generation 1).
"""
from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch import obs

KINDS = ("host_kill", "interrupt", "writer_crash", "corrupt",
         "heartbeat_delay", "commit_delay")
_ALIASES = {"kill": "host_kill", "crash": "writer_crash",
            "delay": "heartbeat_delay"}
WRITE_PHASES = ("write_begin", "leaves_written", "prepared", "pre_commit",
                "committed")


class ChaosError(RuntimeError):
    """Raised by a ``writer_crash`` event in ``mode=raise`` — exercises
    the CheckpointManager async-error capture path in-process."""


class ChaosInterrupt(RuntimeError):
    """Raised by an ``interrupt`` event at a round boundary — an
    in-process stand-in for a SIGKILL in resume-equality tests."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``round`` is the outer-round index for ``host_kill`` / ``interrupt``
    / ``heartbeat_delay``, and the checkpoint *step* for
    ``writer_crash`` / ``corrupt`` / ``commit_delay``."""
    kind: str
    round: int
    host: int = 0
    phase: str = "leaves_written"     # writer_crash / commit_delay anchor
    mode: str = "kill"                # writer_crash: "kill" | "raise"
    target: str = "bytes"             # corrupt: "bytes" | "manifest" | "commit"
    delay_s: float = 0.25
    generation: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


def corrupt_checkpoint(step_dir: str, target: str = "bytes") -> Optional[str]:
    """Flip bytes in a checkpoint step dir: ``bytes`` damages the first
    leaf ``.npy`` found, ``manifest`` a ``manifest.json``, ``commit``
    truncates the COMMIT marker. Returns the damaged path (None if the
    dir holds nothing to damage)."""
    suffix = {"bytes": ".npy", "manifest": "manifest.json",
              "commit": "COMMIT"}[target]
    victims = []
    for root, _dirs, files in os.walk(step_dir):
        for fn in sorted(files):
            if fn.endswith(suffix):
                victims.append(os.path.join(root, fn))
    if not victims:
        return None
    path = sorted(victims)[0]
    if target == "commit":
        with open(path, "w") as f:
            f.write("{ torn")
        return path
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    return path


class FaultSchedule:
    """The injection engine: holds the events, filters them by this
    host's identity and recovery generation, fires each at most once."""

    def __init__(self, events: Sequence[FaultEvent], *, host: int = 0,
                 generation: int = 0, telemetry=obs.DISABLED,
                 kill=os.kill, sleep=time.sleep):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.host = host
        self.generation = generation
        self.telemetry = telemetry
        self.fired: List[FaultEvent] = []
        self._kill = kill
        self._sleep = sleep

    # -- construction -------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str, **kw) -> "FaultSchedule":
        """Parse ``"kind@round[:k=v[:k=v...]],..."`` — e.g.
        ``"kill@2:host=1,crash@3:host=0:phase=pre_commit:mode=raise"``."""
        events = []
        for entry in filter(None, (s.strip() for s in spec.split(","))):
            head, *opts = entry.split(":")
            kind, _, rnd = head.partition("@")
            kind = _ALIASES.get(kind, kind)
            fields = {"kind": kind, "round": int(rnd)}
            for opt in opts:
                k, _, v = opt.partition("=")
                if k in ("host", "generation"):
                    fields[k] = int(v)
                elif k == "delay_s":
                    fields[k] = float(v)
                elif k in ("phase", "mode", "target"):
                    fields[k] = v
                else:
                    raise ValueError(f"unknown fault option {k!r} in "
                                     f"{entry!r}")
            events.append(FaultEvent(**fields))
        return cls(events, **kw)

    @classmethod
    def seeded(cls, seed: int, *, rounds: int, hosts: int, n_faults: int = 2,
               kinds: Sequence[str] = ("host_kill", "heartbeat_delay",
                                       "writer_crash"), **kw):
        """A reproducible random schedule: same seed ⇒ identical events
        on every host (each host filters to its own)."""
        rng = random.Random(seed)
        events = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            events.append(FaultEvent(
                kind=kind,
                round=rng.randrange(1, max(2, rounds)),
                host=rng.randrange(max(1, hosts)),
                phase=rng.choice(WRITE_PHASES[:4]),
                delay_s=round(rng.uniform(0.05, 0.5), 3)))
        return cls(events, **kw)

    # -- firing -------------------------------------------------------------
    def _due(self, kinds, round_: int):
        for ev in self.events:
            if ev.kind in kinds and ev.round == round_ \
                    and ev.generation == self.generation \
                    and ev.host == self.host and ev not in self.fired:
                yield ev

    def _fire(self, ev: FaultEvent, **ctx):
        self.fired.append(ev)
        self.telemetry.emit("chaos_inject", kind=ev.kind, round=ev.round,
                            host=self.host, phase=ev.phase, mode=ev.mode,
                            target=ev.target, delay_s=ev.delay_s,
                            generation=self.generation, **ctx)

    # -- hook surfaces ------------------------------------------------------
    def round_start(self, rnd: int) -> None:
        """Driver hook, top of every outer round (pre-heartbeat)."""
        for ev in self._due(("host_kill", "interrupt"), rnd):
            self._fire(ev)
            if ev.kind == "host_kill":
                self._kill(os.getpid(), signal.SIGKILL)
            else:
                raise ChaosInterrupt(f"chaos interrupt at round {rnd}")

    def checkpoint_phase(self, step: int, phase: str, directory: str) -> None:
        """``CheckpointManager.hooks`` surface (runs on the writer
        thread)."""
        for ev in self._due(("commit_delay",), step):
            if ev.phase == phase:
                self._fire(ev, write_phase=phase)
                self._sleep(ev.delay_s)
        for ev in self._due(("writer_crash",), step):
            if ev.phase == phase:
                self._fire(ev, write_phase=phase, directory=directory)
                if ev.mode == "kill":
                    self._kill(os.getpid(), signal.SIGKILL)
                raise ChaosError(
                    f"chaos writer crash at step {step} phase {phase}")
        if phase == "committed":
            for ev in self._due(("corrupt",), step):
                self._fire(ev, directory=directory)
                corrupt_checkpoint(directory, ev.target)

    def heartbeat(self, rnd: int) -> None:
        """``fault.HostMonitor.beat`` surface — delay before beating."""
        for ev in self._due(("heartbeat_delay",), rnd):
            self._fire(ev)
            self._sleep(ev.delay_s)
