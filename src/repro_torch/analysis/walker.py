"""Op recorder with source provenance — the port of
``repro/analysis/walker.py``.

The reference walks a traced jaxpr. The port runs eagerly: a program is
the sequence of ATen ops it dispatches when it runs, so the walker's
counterpart is a recorder. :func:`record` runs a callable once under a
``TorchDispatchMode`` and turns every op that reaches the dispatcher into
an :class:`OpSite` carrying

* the **op** (``aten.add``; the overload packet's name);
* the **labels** open at the op: the ``repro_torch.obs`` spans and
  annotations (``obs.trace.open_labels``), the counterpart of the
  reference's ``named_scope`` labels;
* the **source location** (file, line, function) of the innermost
  ``repro_torch`` frame that issued it, this package's own frames
  excluded; where no ``repro_torch`` frame is on the stack (a test's
  fixture), the innermost frame outside torch and the standard library;
* whether the op is a **host read**: ``aten._local_scalar_dense`` (what
  ``.item()``, ``int()``, ``float()`` and ``bool()`` of a tensor
  dispatch), a copy from another device to the CPU, or an op whose
  output shape depends on the data (``nonzero``, boolean-mask indexing
  and their kind). On a card each of these waits for the device.

Nothing here recurses into a body: an eager program has no nested
structure to walk, and the reference's ``pallas_call``-body recursion has
no counterpart. The port's kernels are opaque CUDA launches through
pybind bindings, which the dispatcher never sees, so a kernel call
appears only as the ops its ``torch.autograd.Function`` wrapper
dispatches around the launch (its output allocations); the wrappers'
``LAUNCHES`` count the launches themselves. On a card the autograd
engine runs backward ops on a thread of its own, where only a custom
Function's Python backward leaves a ``repro_torch`` frame.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import math
import os
import sys
import time
from typing import Any, Callable, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.obs.trace import open_labels

__all__ = ["OpSite", "Recording", "record", "ops", "sites", "host_reads",
           "fingerprint", "census", "caller", "origin", "short_path",
           "HOST_READ_OPS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.dirname(_PKG)
_OWN = os.path.dirname(os.path.abspath(__file__))
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)),
         os.path.dirname(os.path.abspath(os.__file__)))

# ops whose result the host reads, or whose output shape depends on the
# data (so the host must read a count before it can allocate)
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten.argwhere", "aten.equal", "aten.is_nonzero", "aten._unique",
    "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
    "aten.masked_scatter",
})
# overloads whose output shape depends on a tensor argument's values
_DATA_SHAPED = frozenset({"aten.repeat_interleave.Tensor",
                          "aten.repeat_interleave.self_Tensor"})
_COPIES = frozenset({"aten._to_copy", "aten.copy_", "aten._copy_from",
                     "aten._copy_from_and_resize"})
_MASKED_INDEX = frozenset({"aten.index", "aten.index_put",
                           "aten.index_put_", "aten._index_put_impl_"})


@dataclasses.dataclass(frozen=True)
class OpSite:
    """One op dispatched by a recorded program."""
    op: str
    labels: Tuple[str, ...]        # obs spans/annotations, outermost first
    file: Optional[str] = None     # source that issued the op
    line: Optional[int] = None
    fn: Optional[str] = None
    host_read: bool = False
    shape: Tuple[int, ...] = ()    # the largest tensor output's shape
    storage: int = 0               # its storage address
    fresh: bool = False            # that storage is no input's (not a view
    #                                or an in-place result)

    @property
    def numel(self) -> int:
        """Elements of the largest output (0 when the op returned no
        tensor)."""
        return math.prod(self.shape) if self.storage else 0

    @property
    def location(self) -> str:
        """``file:line``, the file relative to ``src/`` where it lies
        there; empty when no frame was found."""
        if self.file is None:
            return ""
        return f"{short_path(self.file)}:{self.line}"

    def describe(self) -> str:
        """Human-oriented one-liner: op, labels, source."""
        parts = [self.op + (" (host read)" if self.host_read else "")]
        if self.labels:
            parts.append("under " + "/".join(self.labels))
        if self.file is not None:
            parts.append(f"at {self.location} ({self.fn})")
        return " ".join(parts)


@dataclasses.dataclass
class Recording:
    """What one run of a program dispatched, and what it returned."""
    sites: List[OpSite]
    result: Any = None
    seconds: float = 0.0


@functools.lru_cache(maxsize=None)
def _kind(filename: str) -> str:
    """"pkg" for repro_torch source outside this package, "skip" for
    torch, the standard library, this package and synthetic code, else
    "user"."""
    path = os.path.abspath(filename)
    if filename.startswith("<") or path.startswith(_OWN + os.sep):
        return "skip"
    if path.startswith(_PKG + os.sep):
        return "pkg"
    if any(path.startswith(d + os.sep) for d in _SKIP):
        return "skip"
    return "user"


def short_path(path: str) -> str:
    """``path`` relative to ``src/`` where it lies there."""
    if path.startswith(_SRC + os.sep):
        return os.path.relpath(path, _SRC)
    return path


def caller(frame):
    """(file, line, fn) of the innermost repro_torch frame from ``frame``
    outwards, else of the innermost frame outside torch and the standard
    library; (None, None, None) when there is neither."""
    fallback = (None, None, None)
    while frame is not None:
        code = frame.f_code
        kind = _kind(code.co_filename)
        if kind == "pkg":
            return os.path.abspath(code.co_filename), frame.f_lineno, \
                code.co_name
        if kind == "user" and fallback[0] is None:
            fallback = (os.path.abspath(code.co_filename), frame.f_lineno,
                        code.co_name)
        frame = frame.f_back
    return fallback


def origin(exc: BaseException):
    """:func:`caller` of the innermost frame an exception passed through:
    the line of repro_torch code that raised it."""
    tb = exc.__traceback__
    if tb is None:
        return None, None, None
    while tb.tb_next is not None:
        tb = tb.tb_next
    return caller(tb.tb_frame)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _storage(t) -> int:
    if t is None or t.device.type == "meta":
        return 0
    return t.untyped_storage().data_ptr()


def _is_host_read(func, args, kwargs) -> bool:
    packet = str(func.overloadpacket)
    if packet in HOST_READ_OPS or str(func) in _DATA_SHAPED:
        return True
    if packet in _COPIES:
        ts = _tensors(list(args)) + _tensors(list(kwargs.values()))
        if packet == "aten._to_copy":
            dev = kwargs.get("device")
            return (dev is not None and torch.device(dev).type == "cpu"
                    and args[0].device.type != "cpu")
        if len(ts) >= 2:
            dst, src = (ts[0], ts[1]) if packet == "aten.copy_" \
                else (ts[1], ts[0])
            return dst.device.type == "cpu" and src.device.type != "cpu"
        return False
    if packet in _MASKED_INDEX and len(args) > 1:
        return any(t.dtype in (torch.bool, torch.uint8)
                   for t in _tensors(args[1]))
    return False


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.sites: List[OpSite] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        big = max(outs, key=lambda t: t.numel(), default=None)
        file, line, fn = caller(sys._getframe(1))
        storage = _storage(big)
        inputs = {_storage(t) for t in _tensors(list(args))
                  + _tensors(list(kwargs.values()))}
        # list.append is atomic: the autograd engine's thread records too
        self.sites.append(OpSite(
            op=str(func.overloadpacket), labels=open_labels(), file=file,
            line=line, fn=fn, host_read=_is_host_read(func, args, kwargs),
            shape=() if big is None else tuple(big.shape), storage=storage,
            fresh=bool(storage) and storage not in inputs))
        return out


def record(fn: Callable, *args, **kwargs) -> Recording:
    """Run ``fn(*args, **kwargs)`` once, recording every op it
    dispatches."""
    rec = _Recorder()
    t0 = time.perf_counter()
    with rec:
        result = fn(*args, **kwargs)
    return Recording(rec.sites, result, time.perf_counter() - t0)


def ops(recording: Recording) -> Set[str]:
    """The set of op names (the counterpart of ``primitives``)."""
    return {s.op for s in recording.sites}


def sites(recording: Recording,
          names: Optional[Sequence[str]] = None) -> List[OpSite]:
    """All :class:`OpSite` records, optionally filtered to an op-name
    set — the usual rule-engine entry point."""
    if names is None:
        return list(recording.sites)
    wanted = set(names)
    return [s for s in recording.sites if s.op in wanted]


def host_reads(recording: Recording) -> List[OpSite]:
    return [s for s in recording.sites if s.host_read]


def fingerprint(recording: Recording) -> str:
    """Structural hash of the op sequence: each op with its labels and
    the function that issued it, in order. A re-run from inputs of the
    same shapes gives the same hash; adding, removing or moving an op
    between functions changes it. Line numbers are left out, so an edit
    that only shifts code does not."""
    h = hashlib.sha256()
    for s in recording.sites:
        h.update(f"{s.op}|{'/'.join(s.labels)}|{s.fn}\n".encode())
    return h.hexdigest()


def census(recording: Recording, top: Optional[int] = None, *,
           by: str = "line") -> List[Tuple[str, int]]:
    """Op counts by source line (``by="fn"``: by the function that issued
    them), largest first (ties by name); ops with no source frame count
    under ``"<no frame>"``."""
    key = (lambda s: s.location) if by == "line" else (lambda s: s.fn)
    counts = collections.Counter(key(s) or "<no frame>"
                                 for s in recording.sites)
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return ranked if top is None else ranked[:top]
