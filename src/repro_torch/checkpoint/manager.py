"""Checkpoint manager: atomic directories, asynchronous writes, rotation,
restore of the latest valid step — the port of
``repro/checkpoint/manager.py`` for the flat single-process layout.

Atomicity: write into ``<dir>/tmp.<step>``, then ``os.rename`` it to
``step_<n>``: a crash mid-write leaves only a tmp dir, which is ignored
and removed. Asynchronous: the device-to-host copy happens on the
caller's thread (it pins the values), the disk write on a worker thread
so training overlaps the I/O. A write failure on the worker (disk full,
a failed rename, an injected fault) is kept and raised again on the next
``save()``/``wait()``: training never goes on silently without its
checkpoints. Restore scans the steps newest first and returns the first
whose manifest verifies.

``hooks`` (when set) is called as ``hooks(step, phase, directory)`` at
every write phase: ``write_begin`` -> ``leaves_written`` -> ``prepared``
-> ``committed``.

Restore understands both the flat layout and the sharded runtime's
distributed per-slice layout (``repro_torch.checkpoint.distributed``,
the reference's ``repro/checkpoint/distributed.py``): a committed
distributed step is assembled whole (``read_step_host``), an uncommitted
or unverifiable one is skipped like a torn flat one, so a run moves
between the loop and the sharded drivers across restarts.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Callable, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.tree import tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def _to_host(x):
    return x.detach().to("cpu", copy=True) if hasattr(x, "detach") else x


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # fault-injection hook: hooks(step, phase, directory)
        self.hooks: Optional[Callable[[int, str, str], None]] = None
        # manifest "extra" dict of the step most recently restored
        self.last_extra: dict = {}
        os.makedirs(directory, exist_ok=True)
        # clean stale tmp dirs of crashed runs
        for d in os.listdir(directory):
            if d.startswith("tmp."):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    def _phase(self, step: int, phase: str, directory: str):
        if self.hooks is not None:
            self.hooks(step, phase, directory)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, extra: Optional[dict] = None):
        host_tree = tree_map(_to_host, tree)
        self.wait()                      # joins, and raises a prior failure
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host_tree, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree, extra)

    def _write_guarded(self, step: int, host_tree, extra):
        try:
            self._write(step, host_tree, extra)
        except BaseException as e:  # noqa: BLE001 - raised on the caller
            self._error = e

    def _write(self, step: int, host_tree, extra):
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = step_dir(self.directory, step)
        shutil.rmtree(tmp, ignore_errors=True)
        self._phase(step, "write_begin", tmp)
        ckpt.save(tmp, host_tree, step=step, extra=extra,
                  on_phase=lambda ph: self._phase(step, ph, tmp))
        self._phase(step, "prepared", tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._phase(step, "committed", final)
        self._rotate()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self):
        return sorted(int(m.group(1)) for m in map(
            _STEP_RE.match, os.listdir(self.directory)) if m)

    def _restore_dir(self, d: str, target_tree):
        """Restore one step dir, in either layout; None if it is torn,
        uncommitted or unverifiable."""
        from repro_torch.checkpoint import distributed
        if distributed.is_distributed_dir(d):
            meta = distributed.committed_meta(d)
            if meta is None:
                return None
            tree, step = distributed.read_step_host(d, target_tree,
                                                    meta=meta)
            self.last_extra = dict(meta.get("extra") or {})
            return tree, step
        if not ckpt.is_valid(d):
            return None
        tree, step = ckpt.restore(d, target_tree)
        self.last_extra = dict((ckpt.load_manifest(d) or {})
                               .get("extra") or {})
        return tree, step

    def restore_latest(self, target_tree):
        """(tree, step) from the newest checkpoint that passes the
        integrity check; (None, -1) if there is none."""
        self.wait()
        for s in reversed(self.steps()):
            got = self._restore_dir(step_dir(self.directory, s), target_tree)
            if got is not None:
                return got
        return None, -1

    def restore_step(self, step: int, target_tree):
        """Restore one step; (None, -1) when it is absent or fails
        verification."""
        self.wait()
        d = step_dir(self.directory, step)
        if not os.path.isdir(d):
            return None, -1
        got = self._restore_dir(d, target_tree)
        return got if got is not None else (None, -1)
