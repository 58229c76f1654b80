"""Two-process workers of the port's sharded runtime, launched as
``subprocess.Popen`` ranks of one gloo group (``DIALS_*`` env, see
``repro_torch.distributed.bootstrap``) by the ``tests/test_torch_*``
end-to-end tests. Imports no JAX: a rank starts in seconds.

Every mode runs the tiny traffic trainer
(``repro_torch.analysis.programs.tiny_trainer``, 2x2 grid, the
region-decomposed GS on two row bands) on the CPU, two shards, and rank 0
writes its final state and round records to ``--out`` (``torch.save``).

* ``hostdrop`` — the elastic path: 4 rounds with a ``fault.HostMonitor``
  gate and ``--ckpt-dir``; rank 1 SIGKILLs itself at the top of round 2,
  once its step-2 slice is written. Rank 0's gate times out, the driver
  reassigns rank 1's agent block to rank 0's own mesh
  (``runtime.survivor_mesh``) and finishes the run alone; it exits with
  ``os._exit(0)``, which skips leaving the group next to a dead peer.
* ``resume`` — the distributed checkpoint across a kill: 4 rounds with
  ``--ckpt-dir``; with ``--kill-at R`` both ranks SIGKILL themselves at
  the top of round R (a chaos ``host_kill``, once their step-R slices
  are written), and a second launch without it resumes from the newest
  committed step; with ``--async-collect`` (bound 2) the step carries the
  in-flight collect's round, which the resumed run re-submits.
* ``async`` — the sharded overlapped collect: 3 rounds serial, 3 with
  ``async_collect`` at ``max_aip_staleness=0`` and 3 at 2.

With ``--telemetry-dir`` each rank writes its event log there (the
trainer's and the monitor's events). Prints ``MULTIHOST-OK`` (rank 0)
on success. Ranks that both finish leave the group through
``bootstrap.shutdown`` (a barrier, the destroy) and return normally; only
the host-drop survivor exits with ``os._exit(0)``, as the reference's
does.
"""
import argparse
import os
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.analysis import programs  # noqa: E402
from repro_torch.distributed import bootstrap, chaos, fault  # noqa: E402

# a collective with a stalled peer fails after this long (the group's
# timeout); a dead peer's closed connection fails it at once
GRACE_S = 30.0
# the heartbeat gate's wait for a silent peer
BEAT_TIMEOUT_S = 3.0


def build(**kw):
    return programs.tiny_trainer("traffic", device="cpu", shards=2, **kw)


def dump(path, state, history, **extra):
    torch.save({"aips": state["aips"], "ials": state["ials"],
                "history": history, **extra}, path)


def run_hostdrop(args, ctx):
    tel = obs.maybe(args.telemetry_dir)
    monitor = fault.HostMonitor(args.beat_dir, host=ctx.process_id,
                                n_hosts=2, timeout_s=BEAT_TIMEOUT_S,
                                telemetry=tel if tel.enabled else None)
    trainer = build(outer_rounds=4, ckpt_dir=args.ckpt_dir, ckpt_keep=10,
                    telemetry_dir=args.telemetry_dir)

    def heartbeats(rnd):
        if ctx.process_id == 1 and rnd >= 2:
            # round 1's program and the mirror's all-gather completed on
            # both ranks; the step-2 slice is written: die without a trace
            trainer._dist_manager.wait()
            os.kill(os.getpid(), signal.SIGKILL)
        return monitor.gate(rnd)

    state, history = trainer.run(R.key(0), heartbeats=heartbeats)
    assert ctx.process_id == 0          # only the survivor gets here
    tel.close()
    dump(args.out, state, history, gate_wait_s=monitor.last_wait_s)
    print("MULTIHOST-OK", flush=True)
    os._exit(0)


def run_resume(args, ctx):
    kw = (dict(async_collect=True, max_aip_staleness=2)
          if args.async_collect else {})
    trainer = build(outer_rounds=4, ckpt_dir=args.ckpt_dir, ckpt_keep=10,
                    **kw)
    schedule = None
    if args.kill_at is not None:
        def kill(pid, sig):
            trainer._dist_manager.wait()       # this rank's slice is down
            os.kill(pid, sig)
        schedule = chaos.FaultSchedule(
            [chaos.FaultEvent("host_kill", args.kill_at, host=h)
             for h in range(2)], host=ctx.process_id, kill=kill)
    state, history = trainer.run(R.key(0), chaos=schedule)
    if ctx.is_primary:
        dump(args.out, state, history)
        print("MULTIHOST-OK", flush=True)


def run_async(args, ctx):
    out = {}
    for label, kw in (("serial", {}),
                      ("bound0", dict(async_collect=True,
                                      max_aip_staleness=0)),
                      ("bound2", dict(async_collect=True,
                                      max_aip_staleness=2))):
        state, history = build(outer_rounds=3, **kw).run(R.key(0))
        out[label] = {"aips": state["aips"], "ials": state["ials"],
                      "history": history}
    if ctx.is_primary:
        torch.save(out, args.out)
        print("MULTIHOST-OK", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True,
                    choices=["hostdrop", "resume", "async"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--beat-dir", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--async-collect", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    ctx = bootstrap.bootstrap(peer_death_grace_s=GRACE_S,
                              init_timeout_s=120.0)
    assert ctx.num_processes == 2, ctx
    {"hostdrop": run_hostdrop, "resume": run_resume,
     "async": run_async}[args.mode](args, ctx)
    bootstrap.shutdown()


if __name__ == "__main__":
    sys.exit(main())
