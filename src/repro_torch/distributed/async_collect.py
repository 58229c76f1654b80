"""Double-buffered asynchronous GS collect, and the device ring of
collected datasets — the port of ``repro/distributed/async_collect.py``.

The serial Algorithm-1 round pays the GS collect (Algorithm 2) on the
critical path of every round. The paper's staleness tolerance (Lemma 2 /
Theorem 1) licenses training round k's AIPs on influence data gathered
under the joint policy of round k-1, which is the license to pipeline:
collect round k+1's datasets WHILE round k's F inner IALS steps run.

* :class:`TaggedDataset`: a dataset with the **collection round** of the
  joint policy that produced it, so staleness is a number.
* :class:`AsyncCollector`: one in-flight collect, run by one worker
  thread. On a CUDA device the worker queues the collect on a stream of
  its own, which takes the place of the reference's spare device: the
  collect's kernels run beside the inner steps on the driver's stream.
  :meth:`AsyncCollector.obtain` is the dataset-level freshness gate: it
  harvests the in-flight collect, BLOCKING until it is ready, before any
  force-sync, so the dataset that trains round r depends on r alone and
  never on thread scheduling; a dataset still older than
  ``max_staleness`` rounds is replaced by a fresh blocking collect
  (``max_staleness=0`` is therefore the serial schedule).
* :class:`DeviceRing`: the memory half. Datasets live in a ring of
  device slots written in place, so past each slot's first fill a
  collect allocates no dataset.

Stream order. ``submit`` records an event on the driver's stream and the
collect's stream waits on it: the params the collect reads have been
written, and the slot it overwrites has been read by its last consumer
(round r-1's AIP round, queued on the driver's stream). The worker keeps
the params and the key referenced until its stream has finished, so the
caching allocator cannot hand their memory to the inner steps while the
collect reads it. At harvest the driver's stream waits on the collect's
completion event. The ring's slots are allocated on the driver's stream
before the worker starts (:meth:`DeviceRing.allocate`), so no tensor the
driver reads was allocated on the collect's stream. Constant tables that
an env builds once per device (e.g. ``envs/warehouse._consts``) are
first built on the driver's stream: round 0 primes the pipeline there,
and a resumed run harvests its re-primed collect before the driver's
stream runs anything that reads them.

The sharded driver's ``"dispatch"`` mode and ``spare_device`` belong to
the sharded runtime, which the port does not have yet (ROADMAP queue 1
item 9): they raise.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class TaggedDataset:
    """A collected dataset plus the outer round of the joint policy that
    generated it. ``age = current_round - round`` is the staleness the
    Lemma-2 bound is paid for."""
    data: Any
    round: int


class DeviceRing:
    """A ring of K dataset slots on the device: the wide (N, S, T, ...)
    datasets feed training without a host round trip and, past each
    slot's first fill, without allocating.

    ``collect(params, key)`` rotates through the slots, each call writing
    the fresh dataset in place into the slot's tensors through
    ``collect_into_fn(bufs, params, key)`` (``gs.make_collector_into``).
    A slot's first fill writes into new zero tensors from
    ``zero_slot_fn()`` (``gs.zero_dataset``). The collect overwrites every
    cell, so the result is bit for bit independent of what the slot held.

    Contract, kept by the callers' schedule rather than by locks: a
    returned dataset stays valid for ``slots - 1`` later ``collect()``
    calls; the call after those overwrites its tensors in place. The
    serial loop consumes round r's dataset before round r+1's collect;
    :class:`AsyncCollector`'s obtain-before-submit protocol orders every
    ``collect()`` call across the driver and worker threads, so two slots
    cover both schedules.
    """

    def __init__(self, collect_into_fn, zero_slot_fn, *, slots: int = 2):
        if slots < 2:
            raise ValueError("DeviceRing needs >= 2 slots (consuming + "
                             "in flight)")
        self._into = collect_into_fn
        self._zero_slot = zero_slot_fn
        self._slots = [None] * slots
        self._next = 0

    @property
    def n_slots(self) -> int:
        return len(self._slots)

    def allocate(self) -> None:
        """Give every empty slot its zero tensors now, on the caller's
        current stream (before a worker on another stream collects into
        them)."""
        self._slots = [s if s is not None else self._zero_slot()
                       for s in self._slots]

    def collect(self, params, key):
        """A fresh dataset in the next slot's tensors. Drop-in for the
        plain ``collect_fn(params, key)``."""
        i = self._next
        slot = self._slots[i]
        if slot is None:
            slot = self._zero_slot()
        self._slots[i] = self._into(slot, params, key)
        self._next = (i + 1) % len(self._slots)
        return self._slots[i]


class AsyncCollector:
    """Background executor for the GS collect with one in-flight slot.

    ``collect_fn(params, key) -> dataset`` (the loop driver passes its
    ring's ``collect``). ``device``: a CUDA device runs the collect on a
    stream of its own on that device; None or the CPU runs it on a plain
    worker thread.
    """

    def __init__(self, collect_fn, *, mode: str = "auto",
                 spare_device=None, device=None, telemetry=obs.DISABLED):
        if mode == "dispatch" or spare_device is not None:
            raise NotImplementedError(
                "AsyncCollector mode='dispatch' and spare_device belong to "
                "the sharded runtime, which the port does not have yet "
                "(ROADMAP queue 1 item 9); the loop driver uses "
                "mode='thread'")
        if mode == "auto":
            mode = "thread"
        if mode != "thread":
            raise ValueError(f"unknown dispatch mode {mode!r}")
        self._collect = collect_fn
        self.mode = mode
        self.device = torch.device(device if device is not None else "cpu")
        self.telemetry = telemetry
        # the collect's own stream on a CUDA device
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # host seconds obtain() spent blocked (harvest barrier +
        # force-sync) on its last call: the driver's collect_s phase
        self.last_obtain_wait_s: Optional[float] = None
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gs-collect")
        self._current: Optional[TaggedDataset] = None
        self._pending: Optional[Tuple[int, Any]] = None   # (round, future)

    # -- dispatch -----------------------------------------------------------
    def _run_blocking(self, params, key, ready):
        """The worker: the collect on the collect's stream after ``ready``
        (an event of the driver's stream), then a wait for that stream.
        ``params`` and ``key`` stay referenced until the wait returns.
        Returns (dataset, completion event or None)."""
        if self.stream is None:
            return self._collect(params, key), None
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            data = self._collect(params, key)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return data, done

    def idle(self) -> bool:
        """True when no collect is in flight, i.e. submit() is legal."""
        return self._pending is None

    @property
    def pending_round(self):
        """The in-flight collect's round tag, or None when idle: what a
        checkpoint keeps (``extra["async_round"]``) so a resumed run can
        re-prime the double buffer on the same staleness schedule."""
        return self._pending[0] if self._pending is not None else None

    def submit(self, params, key, round: int) -> None:
        """Launch the collect for ``round``'s joint policy in the
        background. One in-flight collect at a time: the double buffer
        has exactly two slots (consuming + in flight)."""
        if self._pending is not None:
            raise RuntimeError("a collect is already in flight — obtain() "
                               "must harvest it before the next submit()")
        ready = None
        if self.stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        fut = self._executor.submit(self._run_blocking, params, key, ready)
        self._pending = (int(round), fut)

    def collect_now(self, params, key, round: int) -> TaggedDataset:
        """Synchronous (force-sync) collect under the current policy, on
        the caller's stream."""
        return TaggedDataset(self._collect(params, key), int(round))

    # -- the freshness gate -------------------------------------------------
    def obtain(self, current_round: int, params, key, *,
               max_staleness: int) -> Tuple[TaggedDataset, bool]:
        """The dataset to train on at ``current_round``, freshness-gated.

        Steady state: the current slot is one round stale, so the buffers
        swap, blocking on the in-flight collect if it has not finished
        (an exception in the worker is raised here). Force-sync (returns
        True): the dataset is still older than ``max_staleness`` rounds
        after the swap, or there is none, so a fresh blocking collect runs
        under the current policy (tag ``current_round``). The first call
        always primes the pipeline this way.
        """
        t0 = time.perf_counter()
        if self._pending is not None and (
                self._current is None or
                self._current.round < current_round):
            pending_round, fut = self._pending
            self._pending = None
            data, done = fut.result()
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
            self._current = TaggedDataset(data, pending_round)
        forced = (self._current is None or
                  current_round - self._current.round > max_staleness)
        if forced:
            self._current = self.collect_now(params, key, current_round)
        self.last_obtain_wait_s = time.perf_counter() - t0
        self.telemetry.emit(
            "collect_obtain", round=int(current_round),
            data_round=self._current.round, forced=bool(forced),
            mode=self.mode, wait_s=self.last_obtain_wait_s)
        return self._current, forced

    def close(self) -> None:
        """Wait for the worker to finish and drop both slots. A collect
        never harvested (a run stopped between submit and obtain) is
        waited for and dropped unread: the driver is already leaving on
        its own exception then."""
        self._executor.shutdown(wait=True)
        self._pending = None
        self._current = None
