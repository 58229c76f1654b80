"""Post-loss re-bootstrap worker of the port (``repro_torch.distributed.
recovery``), launched by ``tests/test_torch_recovery_*.py`` as two
``subprocess.Popen`` ranks of one gloo group whose store is the external
coordinator (``DIALS_COORDINATOR_EXTERNAL``). Imports no JAX.

A chaos spec kills one rank relative to the checkpoint: ``writer_crash``
SIGKILLs it from its writer thread at a chosen phase while a
``heartbeat_delay`` parks its main thread inside ``monitor.beat`` (so it
never beats that round and is never inside a collective when it dies).
The survivor's gate times out and raises ``HostLossDetected``, and
``recovery.recover`` takes over: finalize a prepared but uncommitted
step, a bounded teardown, shrink to a solo group (env cleared),
``os.execv``. The re-executed process (generation 1) starts solo, so the
driver takes the loop path, which restores the committed distributed
step through the flat manager; it finishes the run, writes its final
state and records to ``--out`` and prints ``RECOVERY-OK``.

The tiny traffic trainer (``repro_torch.analysis.programs.
tiny_trainer``) on the CPU, 5 rounds, two shards while both ranks live.
"""
import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.analysis import programs  # noqa: E402
from repro_torch.distributed import chaos as chaos_mod  # noqa: E402
from repro_torch.distributed import fault, recovery  # noqa: E402

ROUNDS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--beat-dir", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--chaos", default="",
                    help="FaultSchedule.from_spec string (host and "
                         "generation filtering make one spec safe for "
                         "every rank)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    rank = int(os.environ.get("DIALS_PROCESS_ID", "0"))
    # telemetry before startup, so generation 1's rebootstrap event
    # lands in the stream
    tel = (obs.Telemetry.create(args.telemetry_dir, process_id=rank)
           if args.telemetry_dir else obs.DISABLED)
    reco = recovery.RecoveryConfig(teardown_timeout_s=2.0,
                                   init_timeout_s=60.0, retries=4,
                                   backoff_s=0.25, peer_death_grace_s=30.0)
    ctx, gen = recovery.startup(reco=reco, telemetry=tel)
    trainer = programs.tiny_trainer(
        "traffic", device="cpu", outer_rounds=ROUNDS,
        ckpt_dir=args.ckpt_dir, ckpt_keep=10,
        telemetry_dir=args.telemetry_dir)
    schedule = chaos_mod.FaultSchedule.from_spec(
        args.chaos, host=ctx.process_id, generation=gen, telemetry=tel)
    heartbeats, deadman = None, None
    if ctx.num_processes > 1:
        monitor = fault.HostMonitor(
            args.beat_dir, host=ctx.process_id,
            n_hosts=ctx.num_processes, timeout_s=4.0,
            telemetry=tel if tel.enabled else None)
        heartbeats = recovery.raising_gate(monitor)
        # the out-of-band backstop for a peer that dies mid-collective
        deadman = recovery.Deadman(
            args.beat_dir, host=ctx.process_id, n_hosts=ctx.num_processes,
            current_round=lambda: heartbeats.round,
            on_loss=lambda loss: recovery.recover(
                loss, ctx, ckpt_dir=args.ckpt_dir, reco=reco,
                telemetry=tel),
            interval_s=1.0, silence_s=20.0, telemetry=tel).start()
    try:
        state, history = trainer.run(R.key(0), heartbeats=heartbeats,
                                     chaos=schedule)
        if deadman is not None:
            deadman.stop()           # a finished peer is silent, not dead
    except Exception as err:
        loss = recovery.diagnose(err, heartbeats, telemetry=tel)
        if deadman is not None and not deadman.claim():
            threading.Event().wait()  # the watchdog is recovering
        recovery.recover(loss, ctx, ckpt_dir=args.ckpt_dir, reco=reco,
                         telemetry=tel)
        raise AssertionError("recover() returned")
    if gen == 0:
        # the scheduled fault never fired: no recovery to show
        print("NO-FAULT", flush=True)
        return 1
    torch.save({"aips": state["aips"], "ials": state["ials"],
                "history": history, "generation": gen,
                "world": ctx.num_processes}, args.out)
    tel.close()
    print("RECOVERY-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
