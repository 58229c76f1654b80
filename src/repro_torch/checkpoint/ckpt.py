"""Tree <-> disk serialization with an integrity manifest — the port of
``repro/checkpoint/ckpt.py``, in the reference's on-disk layout, so a
checkpoint written by either package restores in the other.

Layout: one ``.npy`` per leaf, named by its path (dict keys and list
indices joined by ``__``, dict keys in sorted order as ``jax.tree``
flattens them) + ``manifest.json`` holding the step, every leaf's name,
shape, dtype and file sha256, and an ``extra`` dict. A checkpoint is
valid iff the manifest exists and every digest matches, so a half-written
one (a killed node) is detected and skipped by the manager.

Leaves are stored in their own dtype; ``restore`` casts each to its
target leaf's dtype, as ``repro_torch.convert`` does: the port's int64
keys and counters come back as the reference's uint32/int32, and the
reference's come back as int64. A bfloat16 leaf is stored as its uint16
bits with the true dtype in the manifest, as the reference stores it.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.tree import unflatten_like

MANIFEST = "manifest.json"


def _flatten(tree, path=()):
    """(path, leaf) pairs in ``jax.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, path + (i,))]
    return [(path, tree)]


def _leaf_name(path) -> str:
    return "__".join(str(k) for k in path) or "leaf"


def _sha256(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(leaf):
    """A leaf as (array to store, its true dtype name)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, tree, *, step: int = 0, extra: Optional[dict] = None,
         on_phase: Optional[Callable[[str], None]] = None):
    """``on_phase`` (if given) is called with ``"leaves_written"`` after
    every leaf file landed but before the manifest: the window where a
    crash leaves an unverifiable (and therefore skipped) checkpoint."""
    os.makedirs(directory, exist_ok=True)
    entries = []
    for path, leaf in _flatten(tree):
        name = _leaf_name(path) + ".npy"
        arr, dtype = _to_numpy(leaf)
        fn = os.path.join(directory, name)
        np.save(fn, arr)
        entries.append({"name": name, "shape": list(arr.shape),
                        "dtype": dtype, "sha256": _sha256(fn)})
    if on_phase is not None:
        on_phase("leaves_written")
    manifest = {"step": step, "leaves": entries, "extra": extra or {}}
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_manifest(directory: str) -> Optional[dict]:
    """The parsed manifest, or None when missing or corrupt."""
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def is_valid(directory: str) -> bool:
    manifest = load_manifest(directory)
    if manifest is None:
        return False
    try:
        for e in manifest["leaves"]:
            fn = os.path.join(directory, e["name"])
            if not os.path.exists(fn) or _sha256(fn) != e["sha256"]:
                return False
        return True
    except (KeyError, TypeError, OSError):
        return False


def _restore_leaf(arr: np.ndarray, true_dtype, target):
    if not torch.is_tensor(target):       # a Python scalar leaf (round)
        return type(target)(arr)
    arr = np.array(arr, order="C")       # writable, and 0-d stays 0-d
    if true_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint leaf {tuple(t.shape)} vs target "
                         f"{tuple(target.shape)}")
    return t.to(dtype=target.dtype, device=target.device)


def restore(directory: str, target_tree):
    """Restore into the structure of ``target_tree`` (its tensors give
    each leaf's shape, dtype and device; a Python scalar leaf comes back
    as its type). Returns (tree, step)."""
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    values = []
    for path, leaf in _flatten(target_tree):
        name = _leaf_name(path) + ".npy"
        try:
            values.append(_restore_leaf(
                np.load(os.path.join(directory, name)), dtypes.get(name),
                leaf))
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    return unflatten_like(target_tree, values), manifest["step"]
