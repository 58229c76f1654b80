"""A two-rank worker that returns normally after a sharded run, launched
as ``subprocess.Popen`` ranks of one gloo group (``DIALS_*`` env, see
``repro_torch.distributed.bootstrap``) by
``tests/test_torch_teardown.py``. Imports no JAX.

It runs the tiny traffic trainer (``repro_torch.analysis.programs.
tiny_trainer``, two shards, its 2 rounds with a distributed
checkpoint under ``--ckpt-dir``: the run after which a finished rank used
to abort in the interpreter's teardown) and then returns from ``main``
without ``os._exit``. ``faulthandler`` dumps every Python thread on a
fatal signal, and an ``atexit`` hook that runs before ``bootstrap``'s
prints the live Python threads (``EXIT-THREADS``), so an abort shows
which threads were alive. One that runs after it prints ``EXIT-LEFT
True`` once the rank has left its group (``False`` while it is still
in one).

``--leave`` chooses how the rank leaves the group:

* ``exit-hook`` (the default) — not at all: ``bootstrap`` registered
  ``bootstrap.shutdown`` with ``atexit``, which leaves it;
* ``shutdown`` — ``bootstrap.shutdown()`` (a barrier, the destroy);
* ``none`` — that hook unregistered, so the interpreter finalises with
  the group alive (the fault's reproduction).

Prints ``TEARDOWN-DONE <rank>`` when its run is done.
"""
import argparse
import atexit
import faulthandler
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import random as R  # noqa: E402
from repro_torch.analysis import programs  # noqa: E402
from repro_torch.distributed import bootstrap  # noqa: E402


def _threads_at_exit():
    alive = [(t.name, t.daemon) for t in threading.enumerate()]
    print(f"EXIT-THREADS {alive}", flush=True)


def _left_at_exit():
    print(f"EXIT-LEFT {not torch.distributed.is_initialized()}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--leave", default="exit-hook",
                    choices=("exit-hook", "shutdown", "none"))
    args = ap.parse_args()
    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    # atexit runs hooks last-registered first: this one after bootstrap's
    atexit.register(_left_at_exit)
    ctx = bootstrap.bootstrap(peer_death_grace_s=30.0, init_timeout_s=120.0)
    assert ctx.num_processes == 2, ctx
    # registered after bootstrap's hook, so it runs before it
    atexit.register(_threads_at_exit)
    trainer = programs.tiny_trainer("traffic", device="cpu", shards=2,
                                    ckpt_dir=args.ckpt_dir, ckpt_keep=10)
    trainer.run(R.key(0))
    if args.leave == "shutdown":
        bootstrap.shutdown()
    elif args.leave == "none":
        atexit.unregister(bootstrap.shutdown)
    print(f"TEARDOWN-DONE {ctx.process_id}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
