"""Declarative contract rules over the port's programs — the port of
``repro/analysis/contracts.py``.

The reference's programs are jitted XLA programs, and its contracts are
claims about what a traced jaxpr may contain. The port's programs are
eager callables (the loop driver's collect, AIP round, inner step, GS
eval, the kernel ops), so its contracts are claims about what a program
does when it runs: the ops it dispatches (``walker.record``), what it
allocates, what it returns, what a card's sync-debug mode sees, and
whether it can be captured as one CUDA graph, PyTorch's counterpart of
"this function is one program". Each contract is a :class:`ContractRule`
checked against :class:`Program` records; violations come back as
``report.Finding``s whose file:line points at the repro_torch source
that issued the offending op, not at the checker.

Rule catalogue:

``NoHostSync``         (the reference's ``NoHostCallback``) a program
                       contains no host read: no ``.item()`` or scalar
                       conversion of a tensor, no copy to the CPU, no op
                       whose output shape depends on the data. On the CPU
                       it exempts exactly one thing, the range checks
                       ATen's ``one_hot`` makes with ``.item()`` on CPU
                       tensors only (on CUDA it relies on device
                       asserts), recognised at their call sites: a
                       ``_local_scalar_dense`` right after the
                       ``aminmax``/``min``/``max`` of the same source
                       line, and that line calls ``one_hot(``
                       (:func:`cpu_one_hot_check`). On a card nothing is
                       exempt, and the program also runs once under
                       ``torch.cuda.set_sync_debug_mode("error")``, the
                       authority on what synchronises there.
``DtypeRoundTrip``     with bf16 inputs the program returns bf16 outputs:
                       kernels may accumulate in f32 inside but cast
                       back.
``RingBufferResident`` (also carries ``DonationUsed``'s claim: torch has
                       no buffer donation) the ring collect writes into
                       the retired slot: every leaf it returns is the
                       slot's own tensor (same ``data_ptr``, shape and
                       dtype, those of ``gs.zero_dataset``), it
                       allocates no dataset-sized tensor, and nothing
                       goes to the host.
``ScalarSyncBudget``   the round record holds host scalars of the
                       ``obs.metrics`` round schema and no others; on a
                       card, the driver's synchronising calls in a steady
                       round (:class:`SyncCounter`, by source line) do
                       not grow with F (``meta["sync_counts"]``).
``GraphCapturable``    (card only) after a warm-up on a side stream the
                       program is captured with ``torch.cuda.graph``; one
                       replay from the same inputs equals the eager call
                       bit for bit, and a run of replays, each output fed
                       back into the static inputs (``meta["feedback"]``),
                       equals as many eager calls bit for bit.

``CollectiveFree``     the sharded runner's per-shard train body
                       (``repro_torch.core.dials_sharded``) dispatches no
                       c10d op (``runtime.COLLECTIVE_PRIMS``): nothing
                       crosses shards between AIP refreshes.
``HaloOnly``           every region-decomposed GS body
                       (``repro_torch.core.gs_sharded``) dispatches only
                       halo sends and receives (``runtime.HALO_PRIMS``),
                       and at least one. A one-shard ring exchanges with
                       itself and dispatches nothing: there the program
                       must advance the halo counter
                       (``collectives.STATS``) instead.

``ReshardCollectives`` checks the elastic reshard, which comes with the
sharded runtime's fault-tolerance half (ROADMAP queue 1 item 9).

Programs carry ``roles`` tags; each rule declares which roles it applies
to, and :func:`run_rules` does the cross product.
"""
from __future__ import annotations

import collections
import dataclasses
import linecache
import statistics
import sys
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import walker
from repro_torch.analysis.report import Finding, format_finding
from repro_torch.tree import leaves, tree_map

__all__ = [
    "Program", "ContractRule", "run_rules", "raise_findings",
    "DEFAULT_RULES", "NoHostSync", "DtypeRoundTrip", "RingBufferResident",
    "ScalarSyncBudget", "GraphCapturable", "CollectiveFree", "HaloOnly",
    "SyncCounter", "cpu_one_hot_check",
]

TAG = "CONTRACT-VIOLATION"
SYNC_MESSAGE = "synchronizing CUDA operation"
# what ATen's CPU one_hot reads its range check from
_RANGE_OPS = frozenset({"aten.aminmax", "aten.min", "aten.max"})


@dataclasses.dataclass
class Program:
    """One program under audit: ``fn(*args)`` on real tensors.

    ``roles`` routes rules. ``meta`` carries what a rule needs beyond
    the call: ``expect`` (the ring slot's (shape, dtype) leaves),
    ``feedback(args, out) -> args`` (the next call's inputs from an
    output), ``replays``, ``record`` and ``sync_counts`` (the round
    record and per-F sync counts a card run measured).
    """
    name: str
    roles: Tuple[str, ...]
    fn: Optional[Callable] = None
    args: Tuple = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _recording: Any = dataclasses.field(default=None, init=False,
                                        repr=False)
    _args_before: Any = dataclasses.field(default=None, init=False,
                                          repr=False)

    @property
    def device(self) -> torch.device:
        """The device of the first tensor among the arguments."""
        for x in leaves(self.args):
            if isinstance(x, torch.Tensor):
                return x.device
        return torch.device(self.meta.get("device", "cpu"))

    def recording(self) -> walker.Recording:
        """One recorded run (cached): the ops the program dispatched.
        The arguments' (data_ptr, shape, dtype) are kept from before it."""
        if self._recording is None:
            self._args_before = _struct(self.args)
            self._recording = walker.record(self.fn, *self.args)
        return self._recording


def _struct(tree):
    return [(x.data_ptr(), tuple(x.shape), x.dtype) if
            isinstance(x, torch.Tensor) else None for x in leaves(tree)]


def _site_finding(rule: str, program: Program, site: walker.OpSite,
                  message: str) -> Finding:
    return Finding(tag=TAG, rule=rule, file=site.file, line=site.line,
                   message=f"{program.name}: {message} — "
                           f"{site.describe()}")


def _origin_finding(rule: str, program: Program, exc: BaseException,
                    message: str) -> Finding:
    file, line, fn = walker.origin(exc)
    first = str(exc).strip().split("\n", 1)[0]
    where = f" in {fn}" if fn else ""
    return Finding(tag=TAG, rule=rule, file=file, line=line,
                   message=f"{program.name}: {message}{where} — "
                           f"{type(exc).__name__}: {first}")


class ContractRule:
    """Base rule: ``roles`` it applies to + a ``check`` returning
    findings (empty list = contract satisfied)."""
    name: str = "ContractRule"
    roles: Tuple[str, ...] = ()

    def applies(self, program: Program) -> bool:
        return any(r in program.roles for r in self.roles)

    def check(self, program: Program) -> List[Finding]:
        raise NotImplementedError


def cpu_one_hot_check(sites: Sequence[walker.OpSite], i: int) -> bool:
    """Is ``sites[i]`` one of the ``.item()`` range checks ATen's
    ``one_hot`` makes on CPU tensors: a ``_local_scalar_dense`` (or a run
    of them) right after an ``aminmax``/``min``/``max`` of the same
    source line, where that line calls ``one_hot(``?"""
    s = sites[i]
    if s.op != "aten._local_scalar_dense" or s.file is None:
        return False
    j = i - 1
    while j >= 0 and sites[j].op == s.op and \
            (sites[j].file, sites[j].line) == (s.file, s.line):
        j -= 1
    if j < 0 or sites[j].op not in _RANGE_OPS or \
            (sites[j].file, sites[j].line) != (s.file, s.line):
        return False
    return "one_hot(" in linecache.getline(s.file, s.line)


def _host_reads(program: Program) -> List[walker.OpSite]:
    """The program's host reads; on the CPU without ``one_hot``'s range
    checks."""
    sites = program.recording().sites
    cpu = program.device.type == "cpu"
    return [s for i, s in enumerate(sites) if s.host_read
            and not (cpu and cpu_one_hot_check(sites, i))]


class NoHostSync(ContractRule):
    """No host read inside a program; on a card, no synchronising call
    under ``set_sync_debug_mode("error")`` either."""
    name = "NoHostSync"
    roles = ("collect", "program")

    def check(self, program: Program) -> List[Finding]:
        out = [_site_finding(self.name, program, s,
                             "host read inside a loop-driver program (a "
                             "device->host sync on the card)")
               for s in _host_reads(program)]
        if program.device.type == "cuda":
            out.extend(self._sync_debug(program))
        return out

    def _sync_debug(self, program: Program) -> List[Finding]:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            program.fn(*program.args)
        except RuntimeError as e:
            if SYNC_MESSAGE not in str(e):
                raise
            return [_origin_finding(self.name, program, e,
                                    "synchronising CUDA call")]
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return []


def _float_dtypes(tree) -> set:
    return {x.dtype for x in leaves(tree)
            if isinstance(x, torch.Tensor) and x.is_floating_point()}


class DtypeRoundTrip(ContractRule):
    """bf16 in ⇒ bf16 out: no floating output wider than the widest
    floating input."""
    name = "DtypeRoundTrip"
    roles = ("dtype",)

    def check(self, program: Program) -> List[Finding]:
        try:
            result = program.fn(*program.args)
        except Exception as e:       # a program that cannot run at reduced
            #                          precision has a dtype bug by definition
            return [_origin_finding(self.name, program, e,
                                    "does not run at reduced precision")]
        in_floats = _float_dtypes(program.args)
        if not in_floats:
            return []
        widest = max(dt.itemsize for dt in in_floats)
        return [Finding(
            tag=TAG, rule=self.name,
            message=f"{program.name}: output leaf {i} is {x.dtype} but the "
                    f"widest floating input is {widest * 8}-bit — a silent "
                    f"upcast through the kernel path")
            for i, x in enumerate(leaves(result))
            if isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype.itemsize > widest]


class RingBufferResident(ContractRule):
    """The ring collect writes into the retired slot and never leaves
    the device.

    ``args[0]`` is the slot. The collect must return the slot's own
    tensors (``data_ptr``, shape and dtype unchanged, those of
    ``meta["expect"]`` when given: ``gs.zero_dataset``'s), allocate no
    dataset-sized tensor (a fresh op output whose dims are those of a
    per-feature leaf, (N, S, T, F) in any order, or that is larger than
    the largest leaf; the (N, S, T) reset flags are left to the pointer
    check, since a step's (S, N, hidden) activation can share their
    dims), and read nothing on the host. A reallocated leaf doubles the
    ring's steady-state memory and copies the whole dataset every
    round."""
    name = "RingBufferResident"
    roles = ("ring_collect",)

    def check(self, program: Program) -> List[Finding]:
        rec = program.recording()
        slot_before = program._args_before[:len(leaves(program.args[0]))]
        out = [_site_finding(self.name, program, s,
                             "host read inside the ring-buffer collect — "
                             "the device-resident dataset reached the "
                             "host") for s in _host_reads(program)]
        got = _struct(rec.result)
        expect = program.meta.get("expect")
        if expect is not None and [g[1:] for g in got if g] != \
                [tuple(e) for e in expect]:
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: collect output (shape, dtype) "
                        f"{[g[1:] for g in got if g]} differs from the "
                        f"ring slot's {list(expect)}"))
        if got != slot_before:
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: collect output leaves "
                        f"{[g[0] for g in got if g]} are not the retired "
                        f"slot's tensors {[s[0] for s in slot_before]} — "
                        f"the ring reallocates every round"))
        shapes = {tuple(sorted(s[1])) for s in slot_before
                  if len(s[1]) >= 4}
        biggest = max(x.numel() for x in leaves(program.args[0]))
        for s in rec.sites:
            if s.fresh and (tuple(sorted(s.shape)) in shapes
                            or s.numel > biggest):
                out.append(_site_finding(
                    self.name, program, s,
                    f"allocates a dataset-sized tensor {s.shape} outside "
                    f"the ring slot"))
        return out


def _host_scalar(value) -> bool:
    if isinstance(value, list):
        return all(isinstance(v, int) for v in value)
    return value is None or isinstance(value, (bool, int, float, str))


class ScalarSyncBudget(ContractRule):
    """The round record is the ONLY thing the driver reads per round: its
    keys must come from the typed round schema and its values be host
    scalars; ``meta["sync_counts"]`` (F -> synchronising calls of one
    steady round by source line, measured on a card with
    :class:`SyncCounter`) must not grow with F."""
    name = "ScalarSyncBudget"
    roles = ("round",)

    def check(self, program: Program) -> List[Finding]:
        from repro_torch.obs import metrics
        rec = program.meta.get("record")
        if rec is None:
            rec = program.fn(*program.args)
        if not isinstance(rec, dict):
            return [Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: a round must yield a record "
                        f"dict, got {type(rec).__name__}")]
        out: List[Finding] = []
        extra = set(rec) - set(metrics.ROUND_KEYS)
        if extra:
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: record keys {sorted(extra)} "
                        f"are outside the typed round schema "
                        f"(repro_torch.obs.metrics.ROUND_FIELDS)"))
        for k, v in sorted(rec.items()):
            if not _host_scalar(v):
                out.append(Finding(
                    tag=TAG, rule=self.name,
                    message=f"{program.name}: record[{k!r}] is a "
                            f"{type(v).__name__} — the per-round fetch "
                            f"must move host scalars only"))
        counts = program.meta.get("sync_counts")
        if counts and len({sum(c.values()) for c in counts.values()}) > 1:
            by_f = {f: dict(sorted(c.items())) for f, c in counts.items()}
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: synchronising calls of a steady "
                        f"round grow with F: {by_f}"))
        return out


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _load(static, new) -> None:
    """Copy ``new``'s tensor leaves into ``static``'s, in place."""
    for dst, src in zip(leaves(static), leaves(new)):
        if isinstance(dst, torch.Tensor) and dst is not src:
            dst.copy_(src)


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
         and x.dtype == y.dtype and x.shape == y.shape
         and bool(torch.equal(x, y)))
        or (not isinstance(x, torch.Tensor) and x == y)
        for x, y in zip(la, lb))


class GraphCapturable(ContractRule):
    """(card only) The program is one CUDA graph.

    On a side stream: ``meta["replays"]`` eager calls from copies of the
    inputs, each output fed back as the next inputs
    (``meta["feedback"](args, out) -> args``; the inputs unchanged
    without it), which are also the warm-up capture needs (lazy tables,
    the kernel build, cuBLAS state of the stream); then a capture from
    static copies of the inputs and as many replays, each output copied
    into the static inputs. The first replay must equal the first eager
    call bit for bit, the last the last. Each call's and each replay's
    milliseconds (CUDA events) go into ``meta["timing"]``. A capture
    that fails is a finding naming the line it failed at. The kernels'
    launch counts tick at the capture, not at replays."""
    name = "GraphCapturable"
    roles = ("collect", "program")

    def applies(self, program: Program) -> bool:
        return super().applies(program) and program.device.type == "cuda"

    def check(self, program: Program) -> List[Finding]:
        replays = int(program.meta.get("replays", 2))
        feedback = program.meta.get("feedback") or (lambda args, out: args)
        device = program.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        timing = program.meta.setdefault("timing", {})
        with torch.cuda.stream(stream):
            args, first, eager_ms = _clone(program.args), None, []
            for _ in range(replays):
                out, ms = _timed(lambda: program.fn(*args), stream)
                eager_ms.append(ms)
                first = _clone(out) if first is None else first
                args = feedback(args, out)
            last = out
            static = _clone(program.args)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=stream):
                    captured = program.fn(*static)
            except Exception as e:          # the refusal is the finding
                return [_origin_finding(self.name, program, e,
                                        "cannot be captured as a CUDA "
                                        "graph")]
            replay_ms, first_replay = [], None
            for i in range(replays):
                if i:
                    _load(static, feedback(static, captured))
                _, ms = _timed(graph.replay, stream)
                replay_ms.append(ms)
                if first_replay is None:
                    first_replay = _clone(captured)
        torch.cuda.current_stream(device).wait_stream(stream)
        timing.update(eager_ms=eager_ms, replay_ms=replay_ms,
                      eager_median_ms=statistics.median(eager_ms),
                      replay_median_ms=statistics.median(replay_ms))
        out: List[Finding] = []
        if not _equal(first_replay, first):
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: one graph replay differs from "
                        f"the eager call on the same inputs"))
        if not _equal(captured, last):
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: {replays} graph replays (outputs "
                        f"fed back) differ from {replays} eager calls"))
        del graph
        return out


def _timed(fn, stream):
    """(fn(), its milliseconds on ``stream`` by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    end.synchronize()
    return out, start.elapsed_time(end)


class SyncCounter:
    """Counts the synchronising CUDA calls made while active, by the
    innermost repro_torch source line (card only).

    ``torch.cuda.set_sync_debug_mode("warn")`` turns every call that
    synchronises the host with the device inside ATen (``.item()``, a
    blocking copy, a stream or device synchronise) into a warning; the
    warnings are counted, not shown. An event's ``synchronize`` (the
    phase fences of ``obs.trace``) is no ATen call, so it is counted by
    wrapping ``torch.cuda.Event.synchronize`` while active. ``sites`` is
    a Counter of ``file:line``; :meth:`snapshot` copies it."""

    def __init__(self):
        self.sites: collections.Counter = collections.Counter()

    def snapshot(self) -> collections.Counter:
        return collections.Counter(self.sites)

    def _note(self, frame) -> None:
        file, line, _ = walker.caller(frame)
        self.sites[f"{walker.short_path(file)}:{line}" if file
                   else "<no frame>"] += 1

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if SYNC_MESSAGE in str(message):
            self._note(sys._getframe(1))
        else:
            self._show(message, category, filename, lineno, file, line)

    def __enter__(self) -> "SyncCounter":
        self._mode = torch.cuda.get_sync_debug_mode()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=f".*{SYNC_MESSAGE}")
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        self._event_sync = torch.cuda.Event.synchronize
        counter, original = self, self._event_sync

        def event_synchronize(event):
            counter._note(sys._getframe(1))
            return original(event)

        torch.cuda.Event.synchronize = event_synchronize
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        torch.cuda.Event.synchronize = self._event_sync
        self._warnings.__exit__(*exc)
        return False


class CollectiveFree(ContractRule):
    """No cross-shard communication anywhere in the program."""
    name = "CollectiveFree"
    roles = ("train_body",)

    def check(self, program: Program) -> List[Finding]:
        from repro_torch.distributed import runtime
        return [_site_finding(self.name, program, s,
                              "collective in a body that must be "
                              "collective-free between AIP refreshes")
                for s in walker.sites(program.recording(),
                                      runtime.COLLECTIVE_PRIMS)]


class HaloOnly(ContractRule):
    """Only neighbour halo exchanges, and at least one of them."""
    name = "HaloOnly"
    roles = ("gs_body",)

    def check(self, program: Program) -> List[Finding]:
        from repro_torch.distributed import runtime
        found = walker.sites(program.recording(), runtime.COLLECTIVE_PRIMS)
        out = [_site_finding(self.name, program, s,
                             f"non-halo collective in a region-decomposed "
                             f"GS body (allowed: "
                             f"{sorted(runtime.HALO_PRIMS)})")
               for s in found if s.op not in runtime.HALO_PRIMS]
        if not found and not self._exchanges_on_one_shard(program):
            out.append(Finding(
                tag=TAG, rule=self.name,
                message=f"{program.name}: no halo exchange at all — "
                        f"this is not the region-decomposed GS program"))
        return out

    @staticmethod
    def _exchanges_on_one_shard(program: Program) -> bool:
        """Without other ranks (world size 1) the ring shift is the
        identity and dispatches no c10d op: such a program passes when
        one more call of it advances the halo counter."""
        from repro_torch.distributed import collectives, runtime
        if runtime.world_size() != 1:
            return False
        before = collectives.STATS["halo_exchanges"]
        program.fn(*program.args)
        return collectives.STATS["halo_exchanges"] > before


DEFAULT_RULES: Tuple[ContractRule, ...] = (
    NoHostSync(), DtypeRoundTrip(), RingBufferResident(),
    ScalarSyncBudget(), GraphCapturable(), CollectiveFree(), HaloOnly(),
)


def run_rules(programs: Sequence[Program],
              rules: Sequence[ContractRule] = DEFAULT_RULES
              ) -> List[Finding]:
    """Check every rule against every program it applies to."""
    findings: List[Finding] = []
    for program in programs:
        for rule in rules:
            if rule.applies(program):
                findings.extend(rule.check(program))
    return findings


def raise_findings(findings: Sequence[Finding]) -> None:
    """Turn a non-empty finding list into one AssertionError."""
    if findings:
        raise AssertionError("\n".join(
            format_finding(f, github=False) for f in findings))
