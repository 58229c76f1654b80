"""Repo-specific AST lint of the port — the port of
``repro/analysis/lint.py``.

The contract rules (``repro_torch.analysis.contracts``) hold what a
program does when it runs; this pass holds the *source* to the bug
classes that run fine and fail silently:

``prng-reuse``           a key passed to a second consuming
                         ``repro_torch.random`` call (``split``,
                         ``uniform``, ``bernoulli``, ``randint``,
                         ``categorical``, ``permutation``, ``normal``,
                         ``truncated_normal``, ``random_bits``) without
                         being re-derived: correlated randomness across
                         draws. The ``repro_torch.core.env_pool`` key
                         helpers (``stream_keys`` / ``init_keys`` /
                         ``step_keys``) consume their first argument too:
                         each derives a whole fold-in chain from it.
``prng-discarded-split`` a result of ``split`` bound to a name that is
                         never read (underscore-prefixed names opt out).
``prng-relative-fold``   ``fold_in`` keyed on ``axis_index``: per-agent
                         keys must fold the ABSOLUTE agent id, or
                         randomness changes with the shard count. The
                         port has no sharded runtime yet (ROADMAP queue 1
                         item 9), so nothing trips it today.
``numpy-random``         a ``numpy.random`` *call* in a runtime module:
                         host RNG beside the explicit key streams is a
                         silent nondeterminism leak.
``torch-global-rng``     the port's counterpart: ``torch.rand*``,
                         ``torch.randn*`` and the other sampling
                         functions without an explicit ``generator=``, or
                         ``torch.manual_seed`` and its kind, in a runtime
                         module: the global generator is shared process
                         state that no key stream controls.
``host-time``            ``time.time()``-family calls inside *nested*
                         functions of runtime modules. Depth-1 functions
                         and methods are driver host code where
                         wall-clock spans are the point; nested functions
                         are the programs, where a host clock times the
                         enqueue, not the work.
``host-sync-branch``     (the reference's ``traced-branch``) inside a
                         nested function of ``core/``, ``distributed/`` or
                         ``marl/``: Python ``if``/``while`` on a bare
                         parameter or on a tensor expression, ``bool()``,
                         ``int()`` or ``float()`` of one, or ``.item()``.
                         The nested functions are the programs a CUDA
                         graph captures; each of these reads the device
                         from the host, a sync on the card that no graph
                         can hold. (``is None`` checks and config
                         attributes do not trip it; depth-1 driver code,
                         such as the round's one read of the staleness
                         gate, stays allowed.) A tensor expression is a
                         call of ``torch.*`` or of a tensor method that
                         reduces (``sum``, ``any``, ``max``, ...), or a
                         subscript of a parameter.

Run via ``tools/check_programs_torch.py --lint``; findings carry
file:line and render through ``repro_torch.analysis.report``.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.report import Finding

__all__ = ["lint_source", "lint_file", "lint_paths", "default_targets"]

TAG = "LINT"

# repro_torch.random calls that consume a key's uniqueness
CONSUMING = frozenset({
    "split", "uniform", "bernoulli", "randint", "categorical",
    "permutation", "normal", "truncated_normal", "random_bits",
})
# the names repro_torch.random is imported as
RANDOM_HEADS = ("R", "random", "repro_torch.random")

# repro_torch.core.env_pool helpers that consume their first key
# argument: each derives per-stream fold-in chains from it
POOL_CONSUMING = frozenset({"stream_keys", "init_keys", "step_keys"})

HOST_CLOCKS = frozenset({"time", "perf_counter", "monotonic",
                         "process_time", "perf_counter_ns", "time_ns"})

# torch's global-generator sampling functions (flagged without
# generator=) and seeding calls (always flagged)
GLOBAL_RNG = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson",
})
GLOBAL_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
})
# tensor methods whose result is a device value a host branch would read
TENSOR_REDUCTIONS = frozenset({
    "sum", "mean", "max", "min", "any", "all", "prod", "norm", "std",
    "var", "amax", "amin", "argmax", "argmin", "count_nonzero", "item",
    "abs", "eq", "ne", "gt", "ge", "lt", "le", "isfinite", "isnan",
})
HOST_CASTS = frozenset({"bool", "int", "float"})

# modules whose code runs on the device path (lint targets);
# host-sync-branch additionally restricts to the packages whose nested
# functions are the programs a graph would capture
RUNTIME_DIRS = ("core", "distributed", "kernels", "marl", "nn", "envs",
                "models", "optim", "data")
BRANCH_DIRS = ("core", "distributed", "marl")
NOT_TENSORS = frozenset({"self", "cls", "cfg", "config"})


def _dotted(node) -> str:
    """Best-effort dotted name of an expression (``R.split``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_port_random(call: ast.Call) -> Optional[str]:
    """The repro_torch.random function name of a call, or None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    head, _, fn = _dotted(call.func).rpartition(".")
    return fn if head in RANDOM_HEADS else None


def _is_pool_key_helper(call: ast.Call) -> Optional[str]:
    """The env_pool key-helper name of a call (qualified or bare), or
    None — these consume their first key argument like a draw."""
    if isinstance(call.func, ast.Attribute):
        name = call.func.attr
    elif isinstance(call.func, ast.Name):
        name = call.func.id
    else:
        return None
    return name if name in POOL_CONSUMING else None


def _contains_axis_index(node) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name == "axis_index":
            return True
    return False


def _root_name(node) -> Optional[str]:
    """The name an attribute/subscript/call chain starts from."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _tensorish(node, params) -> bool:
    """Does an expression evaluate to a tensor (by its form)? A bare
    parameter, a subscript of one, a ``torch.*`` call, or a reducing
    tensor method on any of these."""
    if isinstance(node, ast.Name):
        return node.id in params
    if isinstance(node, ast.Subscript):
        return _root_name(node) in params
    if isinstance(node, ast.Call):
        if _dotted(node.func).startswith("torch."):
            return True
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in TENSOR_REDUCTIONS
                and (_root_name(node.func.value) in params
                     or _tensorish(node.func.value, params)))
    return False


def _branch_on_tensor(test, params) -> bool:
    """An if/while test that reads a tensor on the host: a bare
    parameter (``not`` included), a tensor call, or a comparison or
    boolean combination whose operand is one of those."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test = test.operand
    if isinstance(test, ast.Name):
        return test.id in params
    if isinstance(test, ast.Call):
        return _tensorish(test, params)
    if isinstance(test, ast.BoolOp):
        return any(_branch_on_tensor(v, params) for v in test.values)
    if isinstance(test, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return False
        return any(isinstance(v, ast.Call) and _tensorish(v, params)
                   for v in [test.left] + test.comparators)
    return False


def _leaves_function(body) -> bool:
    """Does a block end by leaving the function (return or raise)?"""
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise))


def _own_nodes(fn):
    """Every node of ``fn``'s body, not descending into nested function
    or class definitions (those are checked on their own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                stack.append(child)


class _KeyState:
    """Per-function key dataflow: which names hold keys that were
    already consumed, which split results still await a read, and which
    names carry shard-relative (``axis_index``-derived) data."""

    def __init__(self):
        self.consumed: Dict[str, Tuple[int, str]] = {}   # name -> (line, by)
        self.split_unused: Dict[str, int] = {}           # name -> line
        self.relative: set = set()                       # axis_index data

    def copy(self) -> "_KeyState":
        st = _KeyState()
        st.consumed = dict(self.consumed)
        st.split_unused = dict(self.split_unused)
        st.relative = set(self.relative)
        return st

    def merge(self, other: "_KeyState") -> None:
        # a branch consuming a key counts: union of consumption; a read
        # on either branch satisfies the split result
        self.consumed.update(other.consumed)
        self.relative |= other.relative
        for name in list(self.split_unused):
            if name not in other.split_unused:
                del self.split_unused[name]


class _FunctionLinter:
    """Statement-ordered walk of one function body (branch-aware: an
    ``if`` branch that returns or raises does not flow on; loop bodies
    analysed once — reuse across loop iterations is out of scope)."""

    def __init__(self, checker: "_Checker", depth: int):
        self.checker = checker
        self.depth = depth
        self.state = _KeyState()

    # -- expression pass ------------------------------------------------------
    @staticmethod
    def _is_relative(node, state: _KeyState) -> bool:
        if _contains_axis_index(node):
            return True
        return any(isinstance(sub, ast.Name) and sub.id in state.relative
                   for sub in ast.walk(node))

    def use_expr(self, node, state: _KeyState) -> None:
        """Record name reads + key consumption inside one expression."""
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                state.split_unused.pop(sub.id, None)
            if isinstance(sub, ast.Call):
                self.call(sub, state)

    def call(self, call: ast.Call, state: _KeyState) -> None:
        fn = _is_port_random(call)
        pool_fn = None if fn is not None else _is_pool_key_helper(call)
        if fn is None and pool_fn is None:
            return
        if fn == "fold_in" and len(call.args) >= 2 and \
                self._is_relative(call.args[1], state):
            self.checker.add(call, "prng-relative-fold",
                             "fold_in keyed on axis_index — fold the "
                             "absolute agent id so per-agent randomness "
                             "is shard-count invariant")
        consumes = (fn in CONSUMING) if fn is not None else True
        if consumes and call.args and \
                isinstance(call.args[0], ast.Name):
            name = call.args[0].id
            prior = state.consumed.get(name)
            if prior is not None:
                self.checker.add(
                    call, "prng-reuse",
                    f"key {name!r} already consumed by "
                    f"{prior[1]} at line {prior[0]} — re-deriving "
                    f"(split/fold_in) is required before every "
                    f"consuming call")
            else:
                state.consumed[name] = (
                    call.lineno, f"R.{fn}" if fn is not None
                    else f"env_pool.{pool_fn}")

    # -- statement pass -------------------------------------------------------
    def assign_targets(self, targets, value, state: _KeyState) -> None:
        names: List[str] = []
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    if isinstance(el, ast.Name):
                        names.append(el.id)
        relative = value is not None and self._is_relative(value, state)
        for name in names:
            state.consumed.pop(name, None)       # rebind = fresh key
            state.split_unused.pop(name, None)
            if relative:
                state.relative.add(name)
            else:
                state.relative.discard(name)
        if isinstance(value, ast.Call) and \
                _is_port_random(value) == "split":
            for tgt in targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                for el in elts:
                    if isinstance(el, ast.Name) and \
                            not el.id.startswith("_"):
                        state.split_unused[el.id] = value.lineno

    def run(self, body) -> None:
        self.block(body, self.state)
        for name, line in sorted(self.state.split_unused.items(),
                                 key=lambda kv: kv[1]):
            self.checker.add_at(
                line, "prng-discarded-split",
                f"split result {name!r} is never used — either consume "
                f"it or name it with a leading underscore")

    def block(self, body, state: _KeyState) -> None:
        for stmt in body:
            self.stmt(stmt, state)

    def stmt(self, stmt, state: _KeyState) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.checker.function(stmt, self.depth + 1)
            return
        if isinstance(stmt, ast.Assign):
            self.use_expr(stmt.value, state)
            self.assign_targets(stmt.targets, stmt.value, state)
            return
        if isinstance(stmt, ast.AnnAssign):
            self.use_expr(stmt.value, state)
            if stmt.value is not None:
                self.assign_targets([stmt.target], stmt.value, state)
            return
        if isinstance(stmt, ast.AugAssign):
            self.use_expr(stmt.value, state)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self.branch_check(stmt)
            self.use_expr(stmt.test, state)
            then_state = state.copy()
            self.block(stmt.body, then_state)
            else_state = state.copy()
            self.block(stmt.orelse, else_state)
            # an `if` branch that returns or raises does not flow on: only
            # the branches that fall through carry their consumed keys
            live = [then_state, else_state]
            if isinstance(stmt, ast.If):
                live = [st for st, body in ((then_state, stmt.body),
                                            (else_state, stmt.orelse))
                        if not _leaves_function(body)] or live
            consumed = {}
            for st in live:
                consumed.update(st.consumed)
            then_state.merge(else_state)
            state.consumed = consumed
            state.split_unused = then_state.split_unused
            return
        if isinstance(stmt, ast.For):
            self.use_expr(stmt.iter, state)
            self.assign_targets([stmt.target], None, state)
            self.block(stmt.body, state)
            self.block(stmt.orelse, state)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.use_expr(item.context_expr, state)
            self.block(stmt.body, state)
            return
        if isinstance(stmt, ast.Try):
            self.block(stmt.body, state)
            for handler in stmt.handlers:
                self.block(handler.body, state)
            self.block(stmt.orelse, state)
            self.block(stmt.finalbody, state)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self.use_expr(node, state)

    def branch_check(self, stmt) -> None:
        """``host-sync-branch``: if/while on a tensor in a nested
        function of the program packages."""
        if self.depth < 2 or not self.checker.branch_rules:
            return
        if _branch_on_tensor(stmt.test, self.checker.param_stack[-1]):
            kind = "if" if isinstance(stmt, ast.If) else "while"
            self.checker.add(
                stmt, "host-sync-branch",
                f"Python `{kind}` on a tensor inside a nested function — "
                f"the host reads the device (a sync on the card, which "
                f"no CUDA graph can hold); keep the choice on the device "
                f"(torch.where) or hoist it to the driver")


class _Checker(ast.NodeVisitor):
    def __init__(self, filename: str, *, branch_rules: bool):
        self.filename = filename
        self.branch_rules = branch_rules
        self.findings: List[Finding] = []
        self.param_stack: List[set] = []

    def add(self, node, rule: str, message: str) -> None:
        self.findings.append(Finding(
            tag=TAG, rule=rule, file=self.filename,
            line=getattr(node, "lineno", None), message=message))

    def add_at(self, line: int, rule: str, message: str) -> None:
        self.findings.append(Finding(
            tag=TAG, rule=rule, file=self.filename, line=line,
            message=message))

    # -- module / class walk --------------------------------------------------
    def check_module(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self.flat_call(node)
        for stmt in tree.body:
            self.toplevel(stmt)

    def toplevel(self, stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.function(stmt, 1)
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                self.toplevel(sub)

    def flat_call(self, call: ast.Call) -> None:
        """Position-independent call rules (numpy-random,
        torch-global-rng)."""
        dotted = _dotted(call.func)
        head = dotted.rpartition(".")[0]
        if head in ("np.random", "numpy.random"):
            self.add(call, "numpy-random",
                     f"{dotted}() in a runtime module — host RNG beside "
                     f"the key streams; thread a repro_torch.random key "
                     f"instead")
        seeded = any(k.arg == "generator" for k in call.keywords)
        if dotted in GLOBAL_SEEDING or (dotted in GLOBAL_RNG
                                        and not seeded):
            self.add(call, "torch-global-rng",
                     f"{dotted}() on torch's global generator in a "
                     f"runtime module — pass an explicit generator= or "
                     f"draw from a repro_torch.random key")

    # -- function walk --------------------------------------------------------
    def function(self, fn, depth: int) -> None:
        params = {a.arg for a in (fn.args.posonlyargs + fn.args.args +
                                  fn.args.kwonlyargs)}
        params = {p for p in params
                  if p not in NOT_TENSORS and not p.endswith("_cfg")}
        self.param_stack.append(params)
        if depth >= 2:
            for node in _own_nodes(fn):
                if isinstance(node, ast.Call):
                    self.nested_call(node, params)
        linter = _FunctionLinter(self, depth)
        linter.run(fn.body)
        self.param_stack.pop()

    def nested_call(self, node: ast.Call, params) -> None:
        """Call rules of nested functions: host-time, and the
        host-sync-branch casts and ``.item()``."""
        dotted = _dotted(node.func)
        mod, _, attr = dotted.rpartition(".")
        if mod == "time" and attr in HOST_CLOCKS:
            self.add(node, "host-time",
                     f"time.{attr}() inside a nested function — a host "
                     f"clock there times the enqueue, not the device "
                     f"work; time in the driver instead")
        if not self.branch_rules:
            return
        if isinstance(node.func, ast.Attribute) and node.func.attr == "item" \
                and not node.args:
            self.add(node, "host-sync-branch",
                     ".item() inside a nested function — the host reads "
                     "the device (a sync on the card); keep the value on "
                     "the device or read it in the driver")
        elif isinstance(node.func, ast.Name) and node.func.id in HOST_CASTS \
                and len(node.args) == 1 and \
                _tensorish(node.args[0], params):
            self.add(node, "host-sync-branch",
                     f"{node.func.id}() of a tensor inside a nested "
                     f"function — the host reads the device (a sync on "
                     f"the card); keep the value on the device or read it "
                     f"in the driver")


def lint_source(source: str, filename: str = "<string>", *,
                branch_rules: bool = True) -> List[Finding]:
    """Lint one module's source text (the test-fixture entry point)."""
    tree = ast.parse(source, filename=filename)
    checker = _Checker(filename, branch_rules=branch_rules)
    checker.check_module(tree)
    return checker.findings


def lint_file(path: str, *, branch_rules: Optional[bool] = None
              ) -> List[Finding]:
    if branch_rules is None:
        branch_rules = any(os.sep + d + os.sep in path
                           for d in BRANCH_DIRS)
    with open(path) as f:
        source = f.read()
    return lint_source(source, filename=path, branch_rules=branch_rules)


def default_targets(src_root: str) -> List[str]:
    """The runtime modules the lint pass covers, under ``src_root``
    (= ``.../src/repro_torch``)."""
    out: List[str] = []
    for d in RUNTIME_DIRS:
        base = os.path.join(src_root, d)
        if not os.path.isdir(base):
            continue
        for dirpath, _dirs, files in os.walk(base):
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(files) if f.endswith(".py"))
    return sorted(out)


def lint_paths(paths) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        findings.extend(lint_file(path))
    return findings
