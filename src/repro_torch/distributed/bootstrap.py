"""Multi-process bootstrap — the port of ``repro/distributed/bootstrap.py``.

The sharded runner (``repro_torch.core.dials_sharded``) runs one shard
per process over a ``torch.distributed`` group; this module owns the
process coordination. It keeps the reference's process-group contract:

* :func:`config_from_env` / :func:`add_arguments` /
  :func:`config_from_args` — one contract (coordinator address, process
  count, process id) readable from env vars or CLI flags, so a launcher
  and the launched process agree by construction;
* :func:`bootstrap` — the one call a process makes before it touches
  the group: every rank meets the others on a ``TCPStore`` at the
  coordinator, then ``torch.distributed.init_process_group("gloo",
  store=...)``. A process with no group config gets a
  valid one-process :class:`DistContext` back, so every caller can
  bootstrap unconditionally. For the recovery path
  (``repro_torch.distributed.recovery``) it takes a bounded wait for the
  peers (``init_timeout_s``) and a group timeout (``peer_death_grace_s``,
  :func:`grace_kwargs`): gloo's default of 30 minutes would block a
  collective with a dead peer that long;
* :func:`shutdown` — leave the group. :func:`bootstrap` also registers
  it to run at interpreter exit: a rank whose gloo group is still alive
  when the interpreter finalises can abort after its work is done
  ("terminate called without an active exception", only the main
  Python thread alive), one that left the group first does not
  (``tests/_torch_teardown_check.py``);
* :func:`spawn_local` — ``n`` local ranks under the contract, each in a
  fresh ``spawn``-started process (forking after CUDA has initialised
  fails), on a free loopback port: what the port's tests, examples and
  ``chip_smoke.py`` launch, as the reference's tests launch
  ``jax.distributed`` groups.

Env vars (the ``DIALS_`` namespace, mirrored by the CLI flags):

``DIALS_COORDINATOR``     host:port of the group's TCP store (rank 0's,
                          unless it is external)
``DIALS_NUM_PROCESSES``   total process count
``DIALS_PROCESS_ID``      this process's id in [0, num_processes)
``DIALS_LOCAL_DEVICES``   the reference's forced host-device count. The
                          port runs one shard per process, so only 1 (or
                          unset) is accepted.
``DIALS_COORDINATOR_EXTERNAL``  truthy: the store is an external process
                          (``python -m repro_torch.distributed.coordinator``)
                          and every rank, rank 0 included, connects to it
                          as a client; a store that rank 0 hosts dies with
                          rank 0, and every survivor's store call with it.

The group is gloo because the one machine the port is measured on has a
single card, which every rank shares (NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import socket
import threading
import traceback
from typing import Mapping, Optional

ENV_COORDINATOR = "DIALS_COORDINATOR"
ENV_NUM_PROCESSES = "DIALS_NUM_PROCESSES"
ENV_PROCESS_ID = "DIALS_PROCESS_ID"
ENV_LOCAL_DEVICES = "DIALS_LOCAL_DEVICES"
# truthy: the store at DIALS_COORDINATOR is an external process
# (repro_torch.distributed.coordinator); rank 0 must not host one
ENV_COORDINATOR_EXTERNAL = "DIALS_COORDINATOR_EXTERNAL"
# the recovery incarnation (repro_torch.distributed.recovery), which
# keeps each generation's rendezvous keys apart in a shared store
_ENV_GENERATION = "DIALS_RECOVERY_GENERATION"


@dataclasses.dataclass(frozen=True)
class BootstrapConfig:
    """The process-group contract a coordinated process starts from."""
    coordinator: str
    num_processes: int
    process_id: int
    local_devices: Optional[int] = None

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, "
                             f"got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} outside "
                f"[0, {self.num_processes})")
        if self.local_devices not in (None, 1):
            raise ValueError(
                f"local_devices={self.local_devices}: the port runs one "
                f"shard per process, so {ENV_LOCAL_DEVICES} must be 1 or "
                f"unset (start more processes instead)")

    def env(self) -> dict:
        """The env-var block that reproduces this config in a child
        process (the launcher side of the contract)."""
        out = {ENV_COORDINATOR: self.coordinator,
               ENV_NUM_PROCESSES: str(self.num_processes),
               ENV_PROCESS_ID: str(self.process_id)}
        if self.local_devices is not None:
            out[ENV_LOCAL_DEVICES] = str(self.local_devices)
        return out


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What :func:`bootstrap` hands back: where this process sits."""
    process_id: int
    num_processes: int
    coordinator: Optional[str]
    initialized: bool            # did init_process_group run?

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1


def config_from_env(
        environ: Mapping[str, str] = os.environ) -> Optional[BootstrapConfig]:
    """The env-var side of the contract; None when no group is declared
    (single-process run). Partial declarations are an error: a process
    that was meant to join a group must never silently run solo."""
    keys = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
    present = [k for k in keys if environ.get(k)]
    if not present:
        return None
    missing = [k for k in keys if not environ.get(k)]
    if missing:
        raise ValueError(
            f"incomplete multi-host declaration: {present} set "
            f"but {missing} missing")
    local = environ.get(ENV_LOCAL_DEVICES)
    return BootstrapConfig(
        coordinator=environ[ENV_COORDINATOR],
        num_processes=int(environ[ENV_NUM_PROCESSES]),
        process_id=int(environ[ENV_PROCESS_ID]),
        local_devices=int(local) if local else None)


def add_arguments(parser) -> None:
    """CLI flags mirroring the env vars (flags win where both are set)."""
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's TCP store "
                             f"(or ${ENV_COORDINATOR})")
    parser.add_argument("--num-processes", type=int, default=None,
                        help=f"total process count (or ${ENV_NUM_PROCESSES})")
    parser.add_argument("--process-id", type=int, default=None,
                        help=f"this process's id (or ${ENV_PROCESS_ID})")
    parser.add_argument("--local-devices", type=int, default=None,
                        help="shards per process: 1, the port's only "
                             f"value (or ${ENV_LOCAL_DEVICES})")


def config_from_args(args, environ: Mapping[str, str] = os.environ
                     ) -> Optional[BootstrapConfig]:
    """Resolve :func:`add_arguments` flags over the env (CLI wins
    field-wise)."""
    base = config_from_env(environ)
    fields = {"coordinator": args.coordinator,
              "num_processes": args.num_processes,
              "process_id": args.process_id,
              "local_devices": args.local_devices}
    if all(v is None for v in fields.values()):
        return base
    merged = dataclasses.asdict(base) if base is not None else {
        "coordinator": None, "num_processes": 1, "process_id": 0,
        "local_devices": None}
    merged.update({k: v for k, v in fields.items() if v is not None})
    if merged["coordinator"] is None and merged["num_processes"] > 1:
        raise ValueError("--num-processes > 1 requires --coordinator")
    if merged["coordinator"] is None:
        return BootstrapConfig(coordinator="", num_processes=1,
                               process_id=0,
                               local_devices=merged["local_devices"])
    return BootstrapConfig(**merged)


def external_coordinator(environ: Mapping[str, str] = os.environ) -> bool:
    """Is the store an external process (``DIALS_COORDINATOR_EXTERNAL``)?"""
    return environ.get(ENV_COORDINATOR_EXTERNAL, "") not in ("", "0")


def grace_kwargs(grace_s: float) -> dict:
    """The ``init_process_group`` kwargs that give a surviving process
    ``grace_s`` seconds before a collective with a dead or stalled peer
    fails: the group's timeout (the reference stretches its coordination
    service's missed-heartbeat window by the same name). A dead peer's
    closed connection fails a gloo collective at once; a live peer that
    stopped taking part fails it after the timeout."""
    return {"timeout": datetime.timedelta(seconds=float(grace_s))}


# the store a bootstrap() created; a master store's server lives as long
# as this object does
_STORE = None


def _store_rendezvous(cfg: BootstrapConfig, environ, init_timeout_s):
    """A ``TCPStore`` at the coordinator (hosted by rank 0 unless the
    coordinator is external) on which every rank announces itself and
    waits, up to ``init_timeout_s``, for all the others: the group's
    short timeout then never has to cover a slow peer's start-up."""
    import torch.distributed as dist
    host, _, port = cfg.coordinator.rpartition(":")
    timeout = datetime.timedelta(
        seconds=float(init_timeout_s if init_timeout_s is not None
                      else 300.0))
    store = dist.TCPStore(
        host, int(port), cfg.num_processes,
        is_master=cfg.process_id == 0 and not external_coordinator(environ),
        timeout=timeout, wait_for_workers=False)
    tag = f"dials/arrive/{environ.get(_ENV_GENERATION, '0') or '0'}"
    store.set(f"{tag}/{cfg.process_id}", "1")
    store.wait([f"{tag}/{r}" for r in range(cfg.num_processes)], timeout)
    return store


def bootstrap(cfg: Optional[BootstrapConfig] = None, *,
              environ: Mapping[str, str] = os.environ,
              init_timeout_s: Optional[float] = None,
              peer_death_grace_s: Optional[float] = None) -> DistContext:
    """Join this process's (possibly one-process) group.

    Call once, before any collective. A one-process config (or none)
    returns a one-process :class:`DistContext` without creating a group;
    otherwise every rank meets the others on a ``TCPStore`` at the
    coordinator (rank 0 hosting it unless the coordinator is external,
    ``DIALS_COORDINATOR_EXTERNAL``), waiting at most ``init_timeout_s``
    (300 s by default), and ``init_process_group("gloo", store=...)``
    builds the group on it. Its timeout is ``peer_death_grace_s``
    (:func:`grace_kwargs`) where one is given, else gloo's own."""
    global _STORE
    if cfg is None:
        cfg = config_from_env(environ)
    if cfg is None or cfg.num_processes <= 1:
        return DistContext(process_id=0, num_processes=1, coordinator=None,
                           initialized=False)
    import torch.distributed as dist
    store = _store_rendezvous(cfg, environ, init_timeout_s)
    kwargs = (grace_kwargs(peer_death_grace_s)
              if peer_death_grace_s is not None else {})
    dist.init_process_group("gloo", store=store,
                            world_size=cfg.num_processes,
                            rank=cfg.process_id, **kwargs)
    _STORE = store
    atexit.unregister(shutdown)           # registered once a process
    atexit.register(shutdown)
    return DistContext(process_id=dist.get_rank(),
                       num_processes=dist.get_world_size(),
                       coordinator=cfg.coordinator, initialized=True)


# how long shutdown's barrier waits for the other ranks to arrive
SHUTDOWN_BARRIER_TIMEOUT_S = 30.0
# how long shutdown waits for the destroy once its barrier failed
DEAD_PEER_DESTROY_TIMEOUT_S = 5.0


def shutdown(barrier_timeout_s: Optional[float] = SHUTDOWN_BARRIER_TIMEOUT_S
             ) -> None:
    """Leave the group :func:`bootstrap` joined (no-op without one): a
    barrier bounded by ``barrier_timeout_s`` (None skips it), the group
    destroyed, and a garbage collection so that a group object nothing
    references is freed now and not in the interpreter's finalisation.
    :func:`bootstrap` registers it with ``atexit``, so a script that
    returns without it leaves the group all the same; a rank that
    reached the interpreter's finalisation with its group alive could
    abort after its work was done ("terminate called without an active
    exception"; ``tests/test_torch_teardown.py`` runs the normal
    return). When the barrier fails (a peer died, left or is late) the
    destroy may block, so it runs on a daemon thread and is abandoned
    after ``DEAD_PEER_DESTROY_TIMEOUT_S``."""
    global _STORE
    import gc

    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        peers_met = True
        if barrier_timeout_s is not None and dist.get_world_size() > 1:
            try:
                dist.monitored_barrier(timeout=datetime.timedelta(
                    seconds=barrier_timeout_s))
            except RuntimeError:
                peers_met = False
        if peers_met:
            dist.destroy_process_group()
        else:
            _destroy_bounded(DEAD_PEER_DESTROY_TIMEOUT_S)
    _STORE = None
    gc.collect()


def _destroy_bounded(timeout_s: float) -> None:
    import torch.distributed as dist

    def _destroy():
        try:
            dist.destroy_process_group()
        except Exception:           # noqa: BLE001 - a broken group
            pass
    t = threading.Thread(target=_destroy, daemon=True,
                         name="dials-destroy-group")
    try:
        t.start()
    except RuntimeError:            # no new thread at interpreter exit
        return
    t.join(timeout_s)


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------
def free_port() -> int:
    """A TCP port on the loopback interface that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(value):
    """Tensors -> numpy (a result must outlive the rank that made it)."""
    import torch
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, value)


def _rank_main(rank, cfg_env, fn, args, queue):
    os.environ.update(cfg_env)
    try:
        queue.put((rank, True, _to_host(fn(*args))))
    except BaseException:            # the parent re-raises it by rank
        queue.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown()
        except Exception:           # a broken group has nothing to leave
            pass


def spawn_local(n: int, fn, *args, timeout_s: float = 900.0):
    """Run ``fn(*args)`` in ``n`` fresh local processes, ranks 0..n-1 of
    one group under the ``DIALS_*`` contract (``fn`` calls
    :func:`bootstrap`). Returns the ranks' return values, by rank, with
    every tensor in them (in dicts, lists, tuples) as a numpy array;
    the rest must pickle. A rank that
    raises, dies or outlasts ``timeout_s`` raises here with its
    traceback, after every rank has been stopped."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        env = BootstrapConfig(coordinator=coordinator, num_processes=n,
                              process_id=rank).env()
        p = ctx.Process(target=_rank_main,
                        args=(rank, env, fn, args, results), daemon=False)
        p.start()
        procs.append(p)
    out, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and r not in errors
                        and p.exitcode not in (None, 0)]
                if dead:
                    errors.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode} before "
                                      f"reporting" for r in dead})
                    break
                if time.monotonic() > deadline:
                    errors[-1] = f"ranks timed out after {timeout_s} s"
                    break
                continue
            (out if ok else errors)[rank] = value
            if not ok:
                break
        if not errors:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        detail = "\n".join(f"--- rank {r} ---\n{msg}"
                           for r, msg in sorted(errors.items()))
        raise RuntimeError(f"spawn_local: {len(errors)} of {n} ranks "
                           f"failed\n{detail}")
    return [out[r] for r in range(n)]
