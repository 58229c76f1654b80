"""The device ring of collected datasets — the port of ``DeviceRing`` in
``repro/distributed/async_collect.py``.

``AsyncCollector`` and ``TaggedDataset`` (the overlapped collect) are not
ported yet (ROADMAP queue 1 item 6).
"""
from __future__ import annotations


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
    calls; the call after those overwrites its tensors in place. The loop
    driver consumes round r's dataset before round r+1's collect, so two
    slots cover it.
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
