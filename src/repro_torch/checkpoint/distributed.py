"""Distributed (per-process agent-slice) checkpoints with a two-phase
rank-0 commit — the port of ``repro/checkpoint/distributed.py``, in the
reference's on-disk layout, so a step written by either package restores
in the other.

No process ever materializes the global carry: each process writes only
the contiguous agent block its shard holds (``runtime.shard_agent_tree``'s
tiling) as a complete mini-checkpoint with its own integrity manifest,
and rank 0 turns the slices into a checkpoint atomically with a commit
marker. On-disk layout of one step::

    <dir>/step_<n>/
        agents-00000-00050/      # process A's rows [0, 50): leaf .npy files
            ...  manifest.json   #   + per-slice integrity manifest
        agents-00050-00100/      # process B's rows [50, 100)
        replicated/              # rank 0 only: non-agent leaves (round, key)
        COMMIT                   # rank 0, written LAST: the step's metadata

Two-phase protocol: (prepare) every process writes its slice into a
``.tmp-*`` dir and renames it into place; rank 0 also writes
``replicated/``, then polls until the renamed slices verify and tile
``[0, n_agents)`` exactly, and only then (commit) renames ``COMMIT`` into
place. A host dying mid-write leaves a missing slice or a missing
``COMMIT``, never a torn checkpoint: ``restore_latest`` skips (and may
delete) any step without a verifying ``COMMIT``. A fully prepared step
whose rank 0 died between prepare and commit is completed by any survivor
through :meth:`DistributedCheckpointManager.finalize_pending`.

Leaf classification. The reference puts a leaf into the agent slices
when its JAX sharding splits it along axis 0. Torch tensors carry no
sharding, so the port names them: the subtrees under :data:`AGENT_KEYS`
(the carry's ``aips`` and ``ials``) are this
shard's block of agent-stacked leaves, everything else (``round``,
``key``) is replicated. On a one-shard mesh (or with no mesh) every leaf
goes to ``replicated/``, as the reference writes a single-device array.

Restore is elastic: the saved slice count need not match the reading
mesh. :func:`read_step_mesh` gives each shard its block's rows, read from
the saved slices by range intersection (the ``fault.ElasticPlan`` even
tiling run backwards) and emits the plan as a ``restore_reshard`` event;
:func:`read_step_host` assembles the full tree (the loop driver's and the
flat manager's restore).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager, step_dir
from repro_torch.tree import unflatten_like

COMMIT = "COMMIT"
REPLICATED = "replicated"
# the carry's agent-stacked subtrees (every leaf has leading axis N)
AGENT_KEYS = ("aips", "ials")
_SLICE_RE = re.compile(r"^agents-(\d+)-(\d+)$")


# ---------------------------------------------------------------------------
# leaf naming and classification
# ---------------------------------------------------------------------------
def _named_leaves(tree) -> List[Tuple[str, tuple, object]]:
    """``(file name, path, leaf)`` in ``jax.tree`` order."""
    return [(ckpt._leaf_name(path) + ".npy", path, leaf)
            for path, leaf in ckpt._flatten(tree)]


def _is_agent_leaf(path, leaf) -> bool:
    return (bool(path) and path[0] in AGENT_KEYS and torch.is_tensor(leaf)
            and leaf.ndim >= 1)


def _slice_name(lo: int, hi: int) -> str:
    return f"agents-{lo:05d}-{hi:05d}"


def slice_dirs(d: str) -> List[Tuple[int, int, str]]:
    """Renamed-into-place slice dirs of one step: ``[(lo, hi, path)]``
    sorted by ``lo`` (``.tmp-*`` prepares are excluded by name)."""
    out = []
    for name in os.listdir(d) if os.path.isdir(d) else []:
        m = _SLICE_RE.match(name)
        if m:
            out.append((int(m.group(1)), int(m.group(2)),
                        os.path.join(d, name)))
    return sorted(out)


# ---------------------------------------------------------------------------
# low-level writers
# ---------------------------------------------------------------------------
def write_slice(d: str, block_tree, lo: int, hi: int, n_agents: int, *,
                step: int, tag: str = "w", on_phase=None) -> str:
    """Prepare one agent slice: write ``block_tree`` (rows ``[lo, hi)``)
    into ``.tmp-*`` and rename it into place. Returns the slice path."""
    tmp = os.path.join(d, f".tmp-{_slice_name(lo, hi)}-{tag}")
    final = os.path.join(d, _slice_name(lo, hi))
    shutil.rmtree(tmp, ignore_errors=True)
    ckpt.save(tmp, block_tree, step=step,
              extra={"agents": [lo, hi], "n_agents": n_agents},
              on_phase=on_phase)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


def write_replicated(d: str, rep_tree, *, step: int,
                     extra: Optional[dict] = None, on_phase=None) -> str:
    """Prepare the rank-0 replicated group (it carries the user
    ``extra``)."""
    tmp = os.path.join(d, ".tmp-" + REPLICATED)
    final = os.path.join(d, REPLICATED)
    shutil.rmtree(tmp, ignore_errors=True)
    ckpt.save(tmp, rep_tree, step=step, extra={"user": extra or {}},
              on_phase=on_phase)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


def build_commit_meta(d: str, *, expect_n: Optional[int] = None,
                      verify: bool = True) -> Optional[dict]:
    """The COMMIT metadata of a fully prepared step dir, or None while
    prepare is incomplete: the replicated group and every slice must
    verify, and the slices must tile ``[0, n_agents)`` exactly."""
    rep = os.path.join(d, REPLICATED)
    repm = ckpt.load_manifest(rep)
    if repm is None or (verify and not ckpt.is_valid(rep)):
        return None
    slices = slice_dirs(d)
    n_agents, sharded = 0, []
    if slices:
        first = ckpt.load_manifest(slices[0][2])
        if first is None:
            return None
        n_agents = int(first["extra"].get("n_agents", 0))
        if expect_n is not None and n_agents != expect_n:
            return None
        sharded = sorted(e["name"] for e in first["leaves"])
        nxt = 0
        for lo, hi, path in slices:
            if lo != nxt:
                return None              # gap or overlap in the tiling
            m = ckpt.load_manifest(path)
            if m is None or m["extra"].get("agents") != [lo, hi] \
                    or sorted(e["name"] for e in m["leaves"]) != sharded \
                    or (verify and not ckpt.is_valid(path)):
                return None
            nxt = hi
        if nxt != n_agents:
            return None
    elif expect_n:
        return None
    return {"step": int(repm["step"]), "n_agents": n_agents,
            "slices": [[lo, hi] for lo, hi, _ in slices],
            "sharded": sharded,
            "replicated": sorted(e["name"] for e in repm["leaves"]),
            "extra": dict(repm.get("extra", {}).get("user", {}))}


def write_commit(d: str, meta: dict) -> None:
    tmp = os.path.join(d, ".tmp-" + COMMIT)
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(d, COMMIT))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------
def is_distributed_dir(d: str) -> bool:
    return (os.path.exists(os.path.join(d, COMMIT))
            or os.path.isdir(os.path.join(d, REPLICATED))
            or bool(slice_dirs(d)))


def committed_meta(d: str, *, verify: bool = True) -> Optional[dict]:
    """The COMMIT metadata iff the step is committed AND (``verify``)
    every manifest it names still checks out: a corrupted committed step
    reads as uncommitted and is skipped."""
    try:
        with open(os.path.join(d, COMMIT)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not verify:
        return meta
    try:
        rebuilt = build_commit_meta(d, expect_n=meta.get("n_agents"))
    except (KeyError, TypeError, ValueError, AttributeError):
        return None
    if rebuilt is None or rebuilt["slices"] != meta.get("slices") \
            or rebuilt["sharded"] != meta.get("sharded"):
        return None
    return meta


class SliceReader:
    """Row-range reads across a committed step's slices, each loaded
    ``(slice, leaf)`` array cached, so a restore reads each file once."""

    def __init__(self, d: str, meta: dict):
        self.dir = d
        self.meta = meta
        self.slices = slice_dirs(d)
        self._cache: Dict[Tuple[str, str], np.ndarray] = {}
        self._manifests: Dict[str, Optional[dict]] = {}

    def _manifest(self, path: str) -> dict:
        if path not in self._manifests:
            self._manifests[path] = ckpt.load_manifest(path) or {}
        return self._manifests[path]

    def dtype(self, path: str, name: str) -> Optional[str]:
        """A leaf's true dtype as its manifest names it (``bfloat16`` is
        stored as its uint16 bits)."""
        for e in self._manifest(path).get("leaves", []):
            if e["name"] == name:
                return e["dtype"]
        return None

    def _slice_array(self, path: str, name: str) -> np.ndarray:
        key = (path, name)
        if key not in self._cache:
            self._cache[key] = np.load(os.path.join(path, name))
        return self._cache[key]

    def rows(self, name: str, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` of the sharded leaf ``name``, assembled
        from every saved slice the range intersects."""
        parts = []
        for lo, hi, path in self.slices:
            a, b = max(lo, start), min(hi, stop)
            if a >= b:
                continue
            parts.append(self._slice_array(path, name)[a - lo:b - lo])
        out = np.concatenate(parts, axis=0) if parts else \
            np.zeros((0,), np.float32)
        assert out.shape[0] == stop - start, \
            f"{name}: rows [{start},{stop}) not covered by slices"
        return out

    def sharded_dtype(self, name: str) -> Optional[str]:
        return self.dtype(self.slices[0][2], name) if self.slices else None

    def replicated(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.dir, REPLICATED, name))

    def replicated_dtype(self, name: str) -> Optional[str]:
        return self.dtype(os.path.join(self.dir, REPLICATED), name)


def _to_leaf(arr: np.ndarray, true_dtype, target, shape, device):
    """A stored array as the target leaf: a Python scalar as its type, a
    tensor with ``target``'s dtype on ``device`` (a bfloat16 leaf from
    its uint16 bits)."""
    if not torch.is_tensor(target):
        return type(target)(arr)
    arr = np.array(arr, order="C")
    if true_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf {tuple(t.shape)} vs target "
                         f"{tuple(shape)}")
    return t.to(dtype=target.dtype, device=device)


def read_step_host(d: str, target_tree, *, meta: Optional[dict] = None):
    """Restore a committed step into full tensors shaped like
    ``target_tree`` on its leaves' devices (names absent from the target,
    e.g. the reference's ``reports``, are not read). Returns
    ``(tree, step)``."""
    meta = meta if meta is not None else committed_meta(d)
    if meta is None:
        raise ValueError(f"{d}: not a committed distributed checkpoint")
    reader = SliceReader(d, meta)
    sharded = set(meta["sharded"])
    out = []
    for name, _path, leaf in _named_leaves(target_tree):
        if name in sharded:
            arr = reader.rows(name, 0, meta["n_agents"])
            dt = reader.sharded_dtype(name)
        else:
            arr, dt = reader.replicated(name), reader.replicated_dtype(name)
        shape = tuple(leaf.shape) if torch.is_tensor(leaf) else ()
        device = leaf.device if torch.is_tensor(leaf) else None
        try:
            out.append(_to_leaf(arr, dt, leaf, shape, device))
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    return unflatten_like(target_tree, out), int(meta["step"])


def read_step_mesh(d: str, target_tree, mesh, *,
                   meta: Optional[dict] = None, telemetry=None):
    """Restore a committed step onto ``mesh`` (a ``runtime.ShardMesh``):
    the leaves under :data:`AGENT_KEYS` come back as this shard's block of
    rows on ``mesh.device``, read from whichever saved slices the block
    intersects, so a step written by S shards restores onto any shard
    count; every other leaf comes back whole. ``target_tree`` has the
    full shapes (e.g. ``DIALSTrainer.init``'s state). Returns
    ``(tree, step)``."""
    from repro_torch.distributed import fault
    meta = meta if meta is not None else committed_meta(d)
    if meta is None:
        raise ValueError(f"{d}: not a committed distributed checkpoint")
    reader = SliceReader(d, meta)
    sharded = set(meta["sharded"])
    n_agents = int(meta["n_agents"])
    if sharded and n_agents:
        old = max(1, len(meta["slices"]))
        plan = fault.ElasticPlan(
            n_agents=n_agents, old_shards=old, new_shards=mesh.n_shards,
            dead=(), survivors=tuple(range(old)))
        if telemetry is not None:
            telemetry.emit("restore_reshard", step=int(meta["step"]),
                           n_agents=n_agents, old_shards=plan.old_shards,
                           new_shards=plan.new_shards,
                           slices=meta["slices"])
    out = []
    for name, path, leaf in _named_leaves(target_tree):
        if not torch.is_tensor(leaf):
            out.append(_to_leaf(reader.replicated(name), None, leaf, (),
                                None))
            continue
        shape = tuple(leaf.shape)
        if _is_agent_leaf(path, leaf):
            rows = mesh.block(shape[0])
            shape = (rows.stop - rows.start,) + shape[1:]
            if name in sharded:
                arr = reader.rows(name, rows.start, rows.stop)
                dt = reader.sharded_dtype(name)
            else:                   # saved by one shard: all replicated
                arr = reader.replicated(name)[rows]
                dt = reader.replicated_dtype(name)
            device = mesh.device
        else:
            arr, dt = reader.replicated(name), reader.replicated_dtype(name)
            device = leaf.device
        try:
            out.append(_to_leaf(arr, dt, leaf, shape, device))
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    return unflatten_like(target_tree, out), int(meta["step"])


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
class DistributedCheckpointManager(CheckpointManager):
    """Per-process slice writer and rank-0 two-phase committer.

    Every process calls ``save(step, tree, mesh=...)`` with the same step
    and its shard's tree (the :data:`AGENT_KEYS` subtrees this shard's block,
    the rest whole); each writes its own slice, rank 0 writes the
    replicated group and commits once every slice verifies. One shard (or
    no mesh) writes everything into ``replicated/``: the format is the
    same, so single- and multi-process runs share checkpoints."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True, process_id: int = 0,
                 primary: Optional[bool] = None,
                 commit_timeout_s: float = 60.0, poll_s: float = 0.05,
                 telemetry=None):
        super().__init__(directory, keep=keep, async_write=async_write)
        self.process_id = process_id
        self.primary = (process_id == 0) if primary is None else primary
        self.commit_timeout_s = commit_timeout_s
        self.poll_s = poll_s
        self.telemetry = telemetry
        # each write's seconds: its prepare (this process's files) and,
        # on rank 0, its commit (the wait for every slice, then COMMIT)
        self.timings: List[dict] = []
        # clean slice prepares a crashed writer left inside step dirs
        for s in self.steps():
            d = step_dir(directory, s)
            for name in os.listdir(d):
                if name.startswith(".tmp-"):
                    shutil.rmtree(os.path.join(d, name), ignore_errors=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             mesh=None):
        payload = self._snapshot(tree, mesh)
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, payload, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, payload, extra)

    def _snapshot(self, tree, mesh) -> dict:
        """Caller-thread device-to-host copy: this shard's rows of the
        agent leaves, full values of the replicated ones."""
        split = mesh is not None and mesh.n_shards > 1
        shard_blocks: Dict[str, np.ndarray] = {}
        replicated: Dict[str, object] = {}
        lo = hi = n = None
        for name, path, leaf in _named_leaves(tree):
            host = (leaf.detach().to("cpu", copy=True)
                    if torch.is_tensor(leaf) else leaf)
            key = name[:-len(".npy")]
            if split and _is_agent_leaf(path, leaf):
                rows = leaf.shape[0]
                blk = mesh.block(rows * mesh.n_shards)
                if lo is None:
                    lo, hi, n = blk.start, blk.stop, rows * mesh.n_shards
                else:
                    assert (blk.start, blk.stop) == (lo, hi), \
                        f"{name}: mixed agent blocks in one checkpoint"
                shard_blocks[key] = host
            else:
                replicated[key] = host
        return {"sharded": shard_blocks, "replicated": replicated,
                "lo": lo, "hi": hi, "n": n}

    def _write(self, step: int, payload, extra):
        t0 = time.perf_counter()
        d = step_dir(self.directory, step)
        os.makedirs(d, exist_ok=True)
        self._phase(step, "write_begin", d)
        if payload["sharded"]:
            # rewriting a step saved under an older shard layout: drop
            # stale slices overlapping our range before preparing ours
            for lo, hi, path in slice_dirs(d):
                if lo < payload["hi"] and hi > payload["lo"] and \
                        (lo, hi) != (payload["lo"], payload["hi"]):
                    shutil.rmtree(path, ignore_errors=True)
            write_slice(d, payload["sharded"], payload["lo"], payload["hi"],
                        payload["n"], step=step, tag=f"p{self.process_id}",
                        on_phase=lambda ph: self._phase(step, ph, d))
        self._phase(step, "prepared", d)
        if not self.primary:
            self.timings.append({"step": step,
                                 "prepare_s": time.perf_counter() - t0,
                                 "commit_s": None})
            return
        # a stale COMMIT (a step rewritten after an elastic restart) must
        # drop before the new prepare completes
        try:
            os.remove(os.path.join(d, COMMIT))
        except OSError:
            pass
        write_replicated(d, payload["replicated"], step=step, extra=extra,
                         on_phase=lambda ph: self._phase(step, ph, d))
        t1 = time.perf_counter()
        committed = self._await_commit(d, step, payload["n"])
        self.timings.append({"step": step, "prepare_s": t1 - t0,
                             "commit_s": time.perf_counter() - t1})
        if committed:
            self._phase(step, "committed", d)
            self._rotate()
        elif self.telemetry is not None:
            self.telemetry.emit("ckpt_commit_timeout", step=step,
                                timeout_s=self.commit_timeout_s)

    def _await_commit(self, d: str, step: int, expect_n) -> bool:
        """Phase two: poll until every peer's slice is prepared and
        verifies, then write COMMIT. False on timeout (a peer died
        mid-prepare: the step stays uncommitted, restore skips it)."""
        deadline = time.monotonic() + self.commit_timeout_s
        while True:
            meta = build_commit_meta(d, expect_n=expect_n)
            if meta is not None:
                self._phase(step, "pre_commit", d)
                write_commit(d, meta)
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(self.poll_s)

    def _rotate(self):
        if self.primary:
            super()._rotate()

    # -- restore ------------------------------------------------------------
    def latest_committed(self) -> int:
        """Newest committed and verifying step, or -1."""
        for s in reversed(self.steps()):
            if committed_meta(step_dir(self.directory, s)) is not None:
                return s
        return -1

    def _read(self, d: str, meta: dict, target_tree, mesh):
        self.last_extra = dict(meta.get("extra") or {})
        if mesh is not None:
            return read_step_mesh(d, target_tree, mesh, meta=meta,
                                  telemetry=self.telemetry)
        return read_step_host(d, target_tree, meta=meta)

    def restore_latest(self, target_tree, *, mesh=None, gc: bool = True):
        """``(tree, step)`` from the newest committed step; uncommitted or
        unverifiable newer steps are skipped and (``gc``, rank 0 only)
        deleted. ``mesh``: restore this shard's block
        (:func:`read_step_mesh`) instead of the full tree."""
        self.wait()
        for s in reversed(self.steps()):
            d = step_dir(self.directory, s)
            meta = committed_meta(d)
            if meta is None:
                if gc and self.primary:
                    shutil.rmtree(d, ignore_errors=True)
                continue
            return self._read(d, meta, target_tree, mesh)
        return None, -1

    def restore_step(self, step: int, target_tree, *, mesh=None):
        self.wait()
        d = step_dir(self.directory, step)
        meta = committed_meta(d) if os.path.isdir(d) else None
        if meta is None:
            return None, -1
        return self._read(d, meta, target_tree, mesh)

    # -- recovery -----------------------------------------------------------
    def finalize_pending(self) -> Optional[int]:
        """Commit takeover: complete the newest fully prepared step whose
        writer died between prepare and commit (prepare completeness is
        checkable, and the commit's content is a pure function of the
        prepared files). Returns the finalized step, or None when nothing
        was pending."""
        self.wait()
        for s in reversed(self.steps()):
            d = step_dir(self.directory, s)
            if committed_meta(d) is not None:
                return None              # newest usable step is committed
            meta = build_commit_meta(d)
            if meta is not None:
                write_commit(d, meta)
                if self.telemetry is not None:
                    self.telemetry.emit("ckpt_finalized", step=s)
                return s
        return None
