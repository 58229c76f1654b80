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

The reference's distributed per-slice layout (``repro/checkpoint/
distributed.py``) belongs to the sharded runtime, which the port does
not have yet (ROADMAP queue 1 item 9): a step dir in that layout raises
``NotImplementedError`` instead of being skipped.
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
# what marks a step dir of the reference's distributed layout
_DISTRIBUTED_MARKS = ("COMMIT", "replicated")
_SLICE_RE = re.compile(r"^agents-(\d+)-(\d+)$")


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def _is_distributed_dir(d: str) -> bool:
    names = os.listdir(d)
    return (any(m in names for m in _DISTRIBUTED_MARKS)
            or any(_SLICE_RE.match(n) for n in names))


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
        """Restore one step dir; None if it is torn or unverifiable."""
        if _is_distributed_dir(d):
            raise NotImplementedError(
                f"{d} is in the distributed per-slice checkpoint layout, "
                f"which the port does not read yet (ROADMAP queue 1 item "
                f"9, checkpoint/distributed.py)")
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
