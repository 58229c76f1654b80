"""Standalone (external) coordination service for fault-tolerant groups —
the port of ``repro/distributed/coordinator.py``.

By default rank 0 hosts the group's ``TCPStore`` (``bootstrap``), so
rank 0's death takes the store with it and every survivor's next store
call fails. The survivable topology is a store that no worker hosts:

    python -m repro_torch.distributed.coordinator --bind 127.0.0.1:5432 \\
        --num-processes 2 --ready-file "${TMPDIR:-/tmp}/coord.ready" &

    DIALS_COORDINATOR=127.0.0.1:5432 DIALS_COORDINATOR_EXTERNAL=1 \\
        <launch workers as usual>

With ``DIALS_COORDINATOR_EXTERNAL`` set, every rank, rank 0 included,
connects as a store client (``bootstrap``), so any worker can die without
collapsing the others' coordination channel. The service is a
``torch.distributed.TCPStore`` server (``is_master=True``,
``wait_for_workers=False``); it serves until SIGTERM/SIGINT (or
``--timeout-s``). ``--ready-file`` is written (atomically) once it is
listening, so launchers can sequence worker start-up without polling the
port. The CLI is the reference's.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import threading
from typing import Optional


def serve(bind: str, num_processes: int, *, grace_s: float = 600.0,
          ready_file: Optional[str] = None,
          stop: Optional[threading.Event] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run the store until ``stop`` is set (or ``timeout_s`` elapses).
    Blocks the calling thread. ``grace_s`` is the store's own timeout for
    a client's blocking wait."""
    import torch.distributed as dist
    host, _, port = bind.rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes, is_master=True,
                          timeout=datetime.timedelta(seconds=grace_s),
                          wait_for_workers=False)
    try:
        if ready_file:
            tmp = ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(bind)
            os.replace(tmp, ready_file)
        if stop is None:
            stop = threading.Event()
        stop.wait(timeout_s)
    finally:
        del store                    # the server stops with its object


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="external torch.distributed store for a DIALS group")
    ap.add_argument("--bind", required=True,
                    help="host:port to serve on (workers' "
                         "DIALS_COORDINATOR must point here)")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--grace-s", type=float, default=600.0,
                    help="the store's timeout for a client's blocking "
                         "wait")
    ap.add_argument("--ready-file", default=None,
                    help="written once the service is listening")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="exit after this long even without a signal")
    args = ap.parse_args(argv)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    serve(args.bind, args.num_processes, grace_s=args.grace_s,
          ready_file=args.ready_file, stop=stop, timeout_s=args.timeout_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
