"""Two ranks of one gloo group that break it on purpose, for the
peer-failure markers of ``repro_torch.distributed.recovery``: after one
good all-reduce, rank 1 either SIGKILLs itself (``--mode kill``) or
stops taking part (``--mode stall``, past the group's timeout), and
rank 0's next all-reduce fails. Rank 0 prints the error it got and
whether ``recovery.is_peer_failure`` reads it as a peer failure, as
``PEER-ERROR <repr>`` and ``PEER-FAILURE <bool>``. ``--device cuda``
reduces CUDA tensors (gloo stages them through host memory). Launched
by ``tests/_torch_procs.py``'s ``launch``; imports no JAX."""
import argparse
import os
import signal
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import bootstrap, recovery  # noqa: E402

GRACE_S = 2.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("kill", "stall"), required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    ctx = bootstrap.bootstrap(peer_death_grace_s=GRACE_S,
                              init_timeout_s=60.0)
    x = torch.ones(4, device=args.device)
    dist.all_reduce(x)
    assert float(x.sum()) == 8.0
    if ctx.process_id == 1:
        if args.mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(3 * GRACE_S)
        os._exit(0)
    time.sleep(0.5)
    try:
        dist.all_reduce(x)
        print("PEER-ERROR none", flush=True)
    except Exception as err:      # noqa: BLE001 - what gloo raised
        print(f"PEER-ERROR {type(err).__name__}: {err}", flush=True)
        print(f"PEER-FAILURE {recovery.is_peer_failure(err)}", flush=True)
    recovery.teardown(2.0)
    os._exit(0)


if __name__ == "__main__":
    main()
