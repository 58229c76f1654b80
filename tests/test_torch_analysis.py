"""The port's program contracts (``repro_torch.analysis``) against the JAX
reference's (``repro.analysis``), on the CPU.

Where a reference exists the two are held to each other: finding
formatting, the steady-state compile check, the loop programs' names and
roles, and every lint rule on the reference's own fixtures (restated in
the port's API: the same rule ids at the same lines, ``traced-branch``
being the port's ``host-sync-branch``). Each contract rule gets a good
and a broken fixture; the walker's provenance, labels, census and
fingerprint are checked on the tiny config; the lint and the CPU
contracts are clean on the tree for traffic with both policy kinds. The
full matrix (4 envs x 2 kinds) is ``tools/check_programs_torch.py``'s,
run here only under ``--run-slow``. ``GraphCapturable`` and the sync-debug
half of ``NoHostSync`` need a card: ``tests/test_torch_cuda.py``.
"""
import ast
import collections
import os

import pytest

pytest.importorskip("torch")

import torch

from repro.analysis import lint as ref_lint
from repro.analysis import programs as ref_programs
from repro.analysis import recompile as ref_recompile
from repro.analysis import report as ref_report
from repro_torch.analysis import (contracts, lint, programs, recompile,
                                  report, walker)
from repro_torch.distributed import runtime
from repro_torch.kernels import build
from repro_torch.obs import metrics
from repro_torch.obs.trace import Tracer, annotate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)


# ---------------------------------------------------------------------------
# report + recompile: the reference's semantics
# ---------------------------------------------------------------------------
FINDINGS = [
    dict(tag="CONTRACT-VIOLATION", rule="NoHostSync",
         message="item in body\nsecond line", file="src/x.py", line=12),
    dict(tag="LINT", rule="prng-reuse", message="key reused",
         file="src/y.py"),
    dict(tag="REGRESSION", message="slower"),
    dict(tag="CONTRACT-VIOLATION", rule=None, message="m", file="a.py",
         line=3),
]


@pytest.mark.parametrize("github", [False, True])
@pytest.mark.parametrize("case", range(len(FINDINGS)))
def test_format_finding_matches_reference(case, github):
    fields = FINDINGS[case]
    got = report.format_finding(report.Finding(**fields), github=github)
    want = ref_report.format_finding(ref_report.Finding(**fields),
                                     github=github)
    assert got == want
    assert report.Finding(**fields).location == \
        ref_report.Finding(**fields).location


@pytest.mark.parametrize("counts", [[17, 17, 17], [17, 19, 19],
                                    [0, 1, 3, 3], [5], [], [0, 0, 2, 2, 4]])
def test_check_steady_state_matches_reference(counts):
    key = lambda f: (f.tag, f.rule, f.message, f.file, f.line)
    got = recompile.check_steady_state(counts, what="d")
    want = ref_recompile.check_steady_state(counts, what="d")
    assert [key(f) for f in got] == [key(f) for f in want]


def test_compile_counter_counts_kernel_builds(monkeypatch):
    with recompile.CompileCounter() as cc:
        assert cc.count == 0
        monkeypatch.setattr(build, "_builds", build.build_count() + 1)
        assert cc.count == 1 and cc.names == ["kernel module build"]


# ---------------------------------------------------------------------------
# the program registry
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traffic_programs():
    """The loop programs, a round and the dtype and stream programs on
    traffic, per policy kind, recorded once for the module."""
    out = {}
    for kind in programs.KINDS:
        progs = (programs.loop_programs("traffic", kind=kind, device="cpu")
                 + programs.round_programs("traffic", kind=kind,
                                           device="cpu"))
        out[kind] = progs
    out["other"] = (programs.kernel_dtype_programs(device="cpu")
                    + programs.stream_programs("traffic", device="cpu"))
    return out


def test_loop_programs_names_and_roles_match_reference(traffic_programs):
    want = [(p.name, p.roles) for p in ref_programs.loop_programs("traffic")]
    for kind in programs.KINDS:
        loop = [p for p in traffic_programs[kind]
                if not p.name.endswith("/round")]
        assert [(p.name, p.roles) for p in loop] == want


@pytest.mark.parametrize("kind", programs.KINDS)
def test_cpu_contracts_clean_on_traffic(traffic_programs, kind):
    progs = traffic_programs[kind] + (traffic_programs["other"]
                                      if kind == "fnn" else [])
    findings = contracts.run_rules(progs)
    assert findings == [], "\n".join(
        report.format_finding(f, github=False) for f in findings)
    # GraphCapturable is the card's: it never applies to a CPU program
    assert not any(contracts.GraphCapturable().applies(p) for p in progs)


def _exempt_sites(program):
    sites = program.recording().sites
    return {walker.short_path(s.file).replace(os.sep, "/") + f":{s.line}"
            for i, s in enumerate(sites)
            if s.host_read and contracts.cpu_one_hot_check(sites, i)}


def test_no_host_sync_exempts_only_the_one_hot_sites(traffic_programs):
    """The CPU's only host reads are ATen's one_hot range checks, at
    these call sites; nothing else is exempt."""
    by_name = {p.name.rsplit("/", 1)[1]: p
               for p in traffic_programs["fnn"]}
    want = {
        "collect": {"repro_torch/core/gs.py:78",
                    "repro_torch/envs/traffic.py:93"},
        "ring_collect": {"repro_torch/core/gs.py:78",
                         "repro_torch/envs/traffic.py:93"},
        "ials_train": {"repro_torch/core/ials.py:85",
                       "repro_torch/envs/traffic.py:93"},
        "gs_eval": {"repro_torch/envs/traffic.py:93"},
        "train_aips": set(), "aip_round": set(),
    }
    for name, sites in want.items():
        program = by_name[name]
        assert _exempt_sites(program) == sites, name
        reads = walker.host_reads(program.recording())
        assert len(reads) == sum(
            contracts.cpu_one_hot_check(program.recording().sites, i)
            for i, s in enumerate(program.recording().sites) if s.host_read)


@pytest.mark.parametrize("name", ["collect", "ials_train"])
def test_census_names_threefry_lines_first(traffic_programs, name):
    program = [p for p in traffic_programs["fnn"]
               if p.name.endswith("/" + name)][0]
    rec = program.recording()
    top = walker.census(rec, 5)
    assert all(loc.startswith("repro_torch/random.py:") for loc, _ in top)
    threefry = sum(s.fn in ("_rotl", "threefry2x32") for s in rec.sites)
    assert threefry / len(rec.sites) > 0.6
    counts = dict(walker.census(rec))
    assert sum(counts.values()) == len(rec.sites)
    assert list(counts.values()) == sorted(counts.values(), reverse=True)


def test_fingerprint_stable_on_rerun_and_moved_by_a_change(traffic_programs):
    program = [p for p in traffic_programs["fnn"]
               if p.name.endswith("/aip_round")][0]
    first = walker.fingerprint(program.recording())
    again = walker.record(program.fn, *program.args)
    assert walker.fingerprint(again) == first
    assert walker.ops(again) == walker.ops(program.recording())

    def changed(*args):
        out = program.fn(*args)
        return out[0], out[1] * 1
    assert walker.fingerprint(walker.record(changed, *program.args)) \
        != first


# ---------------------------------------------------------------------------
# walker provenance
# ---------------------------------------------------------------------------
def test_walker_labels_and_provenance():
    tracer = Tracer()
    x = torch.ones(4)

    def body(v):
        with tracer.span("outer"):
            with annotate("inner"):
                y = v * 2.0
            return y + v.sum()

    rec = walker.record(body, x)
    mul = walker.sites(rec, ["aten.mul"])[0]
    assert mul.labels == ("outer", "inner")
    assert mul.file == HERE and mul.fn == "body" and mul.line
    assert "under outer/inner" in mul.describe()
    add = walker.sites(rec, ["aten.add"])[0]
    assert add.labels == ("outer",)
    assert rec.result.shape == (4,) and not walker.host_reads(rec)


def test_walker_marks_host_reads():
    x = torch.arange(6.0)
    rec = walker.record(lambda v: (float(v.sum()), v[v > 2],
                                   torch.nonzero(v)), x)
    reads = collections.Counter(s.op for s in walker.host_reads(rec))
    assert reads["aten._local_scalar_dense"] == 1
    assert reads["aten.nonzero"] == 1
    assert reads["aten.index"] == 1          # boolean-mask indexing
    assert all(s.file == HERE for s in walker.host_reads(rec))


# ---------------------------------------------------------------------------
# contract rules: good and broken fixtures
# ---------------------------------------------------------------------------
def _program(fn, *args, roles=("program",), **meta):
    return contracts.Program(name="fix", roles=roles, fn=fn, args=args,
                             meta=meta)


def test_no_host_sync_rule():
    rule = contracts.NoHostSync()
    x = torch.arange(8)
    assert rule.check(_program(lambda v: v * 2, x)) == []
    assert rule.check(_program(
        lambda v: torch.nn.functional.one_hot(v, 8), x)) == []
    found = rule.check(_program(lambda v: v * v.max().item(), x))
    assert len(found) == 1 and found[0].rule == "NoHostSync"
    assert found[0].file == HERE and found[0].line
    assert "_local_scalar_dense" in found[0].message
    found = rule.check(_program(lambda v: v[v > 3], x))
    assert len(found) == 1 and "aten.index" in found[0].message


def test_dtype_round_trip_rule():
    rule = contracts.DtypeRoundTrip()
    x = torch.ones(4, dtype=torch.bfloat16)
    assert rule.check(_program(lambda v: v * 2, x, roles=("dtype",))) == []
    found = rule.check(_program(lambda v: v.float() * 2, x,
                                roles=("dtype",)))
    assert len(found) == 1 and "silent upcast" in found[0].message
    found = rule.check(_program(lambda v: torch.matmul(v, torch.ones(4, 4)),
                                x, roles=("dtype",)))
    assert len(found) == 1
    assert "does not run at reduced precision" in found[0].message


def _slot():
    return {"feats": torch.zeros((2, 3, 4, 5)),
            "resets": torch.zeros((2, 3, 4))}


def test_ring_buffer_resident_rule():
    rule = contracts.RingBufferResident()
    slot = _slot()
    expect = [((2, 3, 4, 5), torch.float32), ((2, 3, 4), torch.float32)]

    def in_place(bufs):
        for t in range(4):
            bufs["feats"][:, :, t].copy_(torch.full((2, 3, 5), float(t)))
            bufs["resets"][:, :, t].fill_(1.0)
        return bufs

    good = _program(in_place, slot, roles=("ring_collect",), expect=expect)
    assert rule.check(good) == []
    assert slot["feats"][0, 0, 3, 0] == 3.0

    def stacking(bufs):
        steps = [torch.full((2, 3, 5), float(t)) for t in range(4)]
        return {"feats": torch.stack(steps, dim=2), "resets": bufs["resets"]}

    found = rule.check(_program(stacking, _slot(), roles=("ring_collect",),
                                expect=expect))
    messages = " ".join(f.message for f in found)
    assert "dataset-sized tensor (2, 3, 4, 5)" in messages
    assert "not the retired slot's tensors" in messages
    assert any(f.file == HERE and f.line for f in found)

    def host_read(bufs):
        bufs["resets"].add_(float(bufs["feats"].sum()))
        return bufs

    found = rule.check(_program(host_read, _slot(), roles=("ring_collect",),
                                expect=expect))
    assert len(found) == 1 and "reached the host" in found[0].message

    found = rule.check(_program(lambda b: {"resets": b["resets"]}, _slot(),
                                roles=("ring_collect",), expect=expect))
    assert any("differs from the ring slot's" in f.message for f in found)


def test_scalar_sync_budget_rule():
    rule = contracts.ScalarSyncBudget()
    rec = {k: 0 for k in metrics.ROUND_KEYS}
    prog = lambda r, **meta: contracts.Program(
        name="fix", roles=("round",), meta={"record": r, **meta})
    assert rule.check(prog(rec)) == []
    found = rule.check(prog({**rec, "surprise": 1.0}))
    assert any("outside the typed round schema" in f.message for f in found)
    found = rule.check(prog({**rec, "gs_return": torch.zeros(())}))
    assert any("host scalars only" in f.message for f in found)
    same = {2: collections.Counter({"a.py:1": 3}),
            5: collections.Counter({"a.py:1": 3})}
    assert rule.check(prog(rec, sync_counts=same)) == []
    grows = {2: collections.Counter({"a.py:1": 3}),
             5: collections.Counter({"a.py:1": 3, "b.py:2": 3})}
    found = rule.check(prog(rec, sync_counts=grows))
    assert len(found) == 1 and "grow with F" in found[0].message
    # a real round of the driver (the registry's round program)
    record = programs.round_programs("traffic", device="cpu")[0]
    assert rule.check(record) == []


def test_run_rules_routes_by_role():
    x = torch.arange(4)
    leaky = lambda v: v * v.max().item()
    hit = contracts.run_rules([_program(leaky, x)])
    assert hit
    assert contracts.run_rules([_program(leaky, x, roles=("other",))]) == []
    with pytest.raises(AssertionError) as e:
        contracts.raise_findings(hit)
    assert "CONTRACT-VIOLATION" in str(e.value)


def test_selftest_fixtures_all_fail():
    from tools import check_programs_torch
    assert check_programs_torch.selftest_failures("cpu") == []


def test_recovery_programs_match_reference_and_pass(tmp_path):
    """The resume path's programs: the reference's roles and re-shard
    transfers (its fused ``round``/``donated`` program has no eager
    counterpart), every rule clean on them; the re-shard rule's verdict
    per collective kind is the reference's, broadcasts allowed as data
    movement."""
    from repro.analysis import contracts as ref_contracts
    want = ref_programs.recovery_programs("traffic")
    got = programs.recovery_programs("traffic", device="cpu",
                                     directory=str(tmp_path))
    # (the reference's GS bodies depend on its process's device mesh)
    for role in ("train_body", "reshard"):
        assert sum(role in p.roles for p in got) == \
            sum(role in p.roles for p in want), role
    assert any("gs_body" in p.roles for p in got)
    assert [p.name.rsplit("/", 1)[1] for p in got if "reshard" in p.roles] \
        == [p.name.rsplit("/", 1)[1] for p in want if "reshard" in p.roles]
    assert all(p.name.startswith("recovery/traffic@1") for p in got)
    findings = contracts.run_rules(got)
    assert findings == [], "\n".join(
        report.format_finding(f, github=False) for f in findings)
    assert ref_contracts.run_rules(
        [p for p in want if "reshard" in p.roles],
        rules=(ref_contracts.ReshardCollectives(),)) == []
    rule = contracts.ReshardCollectives()
    allowed = rule.ALLOWED | runtime.HALO_PRIMS
    hlo = {"c10d.allreduce_": "all-reduce", "c10d.allgather_": "all-gather",
           "c10d._allgather_base_": "all-gather",
           "c10d.reduce_scatter_": "reduce-scatter",
           "c10d._reduce_scatter_base_": "reduce-scatter",
           "c10d.alltoall_": "all-to-all", "c10d.send": "collective-permute",
           "c10d.recv_": "collective-permute"}
    for op, token in hlo.items():
        assert (op in allowed) == (
            token in ref_contracts.ReshardCollectives.ALLOWED), op
    assert "c10d.broadcast_" in allowed
    assert any(isinstance(r, contracts.ReshardCollectives)
               for r in contracts.DEFAULT_RULES)


# ---------------------------------------------------------------------------
# lint: the reference's fixtures, restated in the port's API
# ---------------------------------------------------------------------------
REF_HEAD = "import jax\nimport jax.numpy as jnp\n"
PORT_HEAD = "from repro_torch import random as R\nimport torch\n"
PORT_RULE = {"traced-branch": "host-sync-branch"}
_BRANCH = ("def f(x):\n"
           "    def inner(y):\n"
           "        if y:\n"
           "            return y\n"
           "        return -y\n"
           "    return inner(x)\n")
LINT_FIXTURES = {
    "prng-reuse": (
        "def f(key):\n"
        "    a = jax.random.normal(key, (3,))\n"
        "    b = jax.random.uniform(key, (3,))\n"
        "    return a + b\n",
        "def f(key):\n"
        "    a = R.normal(key, (3,))\n"
        "    b = R.uniform(key, (3,))\n"
        "    return a + b\n"),
    "split-clean": (
        "def f(key):\n"
        "    k1, k2 = jax.random.split(key)\n"
        "    return jax.random.normal(k1, (3,)) + "
        "jax.random.uniform(k2, (3,))\n",
        "def f(key):\n"
        "    k1, k2 = R.split(key)\n"
        "    return R.normal(k1, (3,)) + R.uniform(k2, (3,))\n"),
    "discarded-split": (
        "def f(key):\n"
        "    k1, k2 = jax.random.split(key)\n"
        "    return jax.random.normal(k1, (3,))\n",
        "def f(key):\n"
        "    k1, k2 = R.split(key)\n"
        "    return R.normal(k1, (3,))\n"),
    "underscore-split": (
        "def f(key):\n"
        "    k1, _k2 = jax.random.split(key)\n"
        "    return jax.random.normal(k1, (3,))\n",
        "def f(key):\n"
        "    k1, _k2 = R.split(key)\n"
        "    return R.normal(k1, (3,))\n"),
    "relative-fold": (
        "def f(key):\n"
        "    i = jax.lax.axis_index('shards')\n"
        "    k = jax.random.fold_in(key, i * 4 + 2)\n"
        "    return jax.random.normal(k, (3,))\n",
        "def f(key):\n"
        "    i = axis_index('shards')\n"
        "    k = R.fold_in(key, i * 4 + 2)\n"
        "    return R.normal(k, (3,))\n"),
    "numpy-random": (
        "import numpy as np\n"
        "def f(x):\n"
        "    def inner(y):\n"
        "        return y * np.random.rand()\n"
        "    return inner(x)\n",) * 2,
    "host-time": (
        "import time\n"
        "def f(x):\n"
        "    def inner(y):\n"
        "        return y + time.time()\n"
        "    return inner(x)\n",) * 2,
    "pool-key-reuse": (
        "from repro.core import env_pool\n"
        "def f(key):\n"
        "    a = env_pool.stream_keys(key, 4)\n"
        "    b = env_pool.init_keys(key)\n"
        "    return a, b\n",
        "from repro_torch.core import env_pool\n"
        "def f(key):\n"
        "    a = env_pool.stream_keys(key, 4)\n"
        "    b = env_pool.init_keys(key)\n"
        "    return a, b\n"),
    "branch": (_BRANCH, _BRANCH),
}


@pytest.mark.parametrize("name", sorted(LINT_FIXTURES))
@pytest.mark.parametrize("where", ["distributed", "envs"])
def test_lint_fixture_matches_reference(name, where):
    ref_src, port_src = LINT_FIXTURES[name]
    branch = where == "distributed"
    ref = ref_lint.lint_source(REF_HEAD + ref_src,
                               filename=f"src/repro/{where}/fixture.py",
                               branch_rules=branch)
    port = lint.lint_source(PORT_HEAD + port_src,
                            filename=f"src/repro_torch/{where}/fixture.py",
                            branch_rules=branch)
    want = sorted((PORT_RULE.get(f.rule, f.rule), f.line) for f in ref)
    assert sorted((f.rule, f.line) for f in port) == want
    if name not in ("split-clean", "underscore-split") and \
            (name != "branch" or branch):
        assert want, f"the reference's {name} fixture found nothing"


def _port_lint(src, where="core"):
    return lint.lint_source(PORT_HEAD + src,
                            filename=f"src/repro_torch/{where}/fixture.py",
                            branch_rules=where in lint.BRANCH_DIRS)


def test_lint_torch_global_rng():
    found = _port_lint("def f(shape, gen):\n"
                       "    a = torch.rand(shape)\n"
                       "    b = torch.randn(shape, generator=gen)\n"
                       "    torch.manual_seed(0)\n"
                       "    return a + b\n")
    assert sorted((f.rule, f.line) for f in found) == [
        ("torch-global-rng", 4), ("torch-global-rng", 6)]


def test_lint_host_sync_branch_casts_and_item():
    found = _port_lint("def f(x, n):\n"
                       "    total = int(x.sum())\n"           # depth 1
                       "    def inner(y, t):\n"
                       "        a = float(y.sum())\n"
                       "        b = y.mean().item()\n"
                       "        if y.any():\n"
                       "            a = a + 1\n"
                       "        if t is None or n > 2:\n"
                       "            a = a + 2\n"
                       "        c = int(len(y))\n"
                       "        return a + b + c\n"
                       "    return inner(x, None) + total\n")
    assert sorted((f.rule, f.line) for f in found) == [
        ("host-sync-branch", 6), ("host-sync-branch", 7),
        ("host-sync-branch", 8)]
    assert _port_lint("def f(x):\n"
                      "    def inner(y):\n"
                      "        return float(y.sum())\n"
                      "    return inner(x)\n", where="envs") == []


def test_lint_exiting_branch_does_not_flow_on():
    """A key consumed in a branch that returns is fresh after it (the
    shape of ``nn/init.py``'s orthogonal initializer)."""
    src = ("def f(key, n):\n"
           "    if n < 2:\n"
           "        return R.normal(key, (n,))\n"
           "    return R.uniform(key, (n, n))\n")
    assert _port_lint(src) == []
    assert [f.rule for f in _port_lint(src.replace("return R.normal",
                                                   "x = R.normal"))] \
        == ["prng-reuse"]


_LOOP_EXIT_FIXTURES = {
    "if-break": ("def f(key, xs):\n"
                 "    for x in xs:\n"
                 "        if x:\n"
                 "            a = {normal}(key, (3,))\n"
                 "            break\n"
                 "    return {uniform}(key, (3,))\n"),
    "if-continue": ("def f(key, xs):\n"
                    "    for x in xs:\n"
                    "        if x:\n"
                    "            a = {normal}(key, (3,))\n"
                    "            continue\n"
                    "    return {uniform}(key, (3,))\n"),
    "while-break": ("def f(key, n):\n"
                    "    while n:\n"
                    "        a = {normal}(key, (3,))\n"
                    "        break\n"
                    "    return {uniform}(key, (3,))\n"),
}


@pytest.mark.parametrize("name", sorted(_LOOP_EXIT_FIXTURES))
def test_lint_loop_exit_still_flows_on(name):
    """A key consumed before a ``break`` or ``continue`` reaches the code
    after the loop: its reuse there is flagged, as the reference flags
    it. Only a branch that returns or raises stops the flow."""
    src = _LOOP_EXIT_FIXTURES[name]
    ref = ref_lint.lint_source(
        REF_HEAD + src.format(normal="jax.random.normal",
                              uniform="jax.random.uniform"),
        filename="src/repro/core/fixture.py", branch_rules=True)
    port = _port_lint(src.format(normal="R.normal", uniform="R.uniform"))
    want = sorted((f.rule, f.line) for f in ref)
    assert want and {r for r, _ in want} == {"prng-reuse"}
    assert sorted((f.rule, f.line) for f in port) == want


def test_lint_tree_is_clean():
    findings = lint.lint_paths(lint.default_targets(
        os.path.join(ROOT, "src", "repro_torch")))
    assert findings == [], "\n".join(
        report.format_finding(f, github=False) for f in findings)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------
def _analysis_sources():
    base = os.path.join(ROOT, "src", "repro_torch", "analysis")
    paths = [os.path.join(base, f) for f in sorted(os.listdir(base))
             if f.endswith(".py")]
    return paths + [os.path.join(ROOT, "tools", "check_programs_torch.py")]


@pytest.mark.parametrize("path", _analysis_sources(),
                         ids=os.path.basename)
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path} imports {bad}"


@pytest.mark.slow
def test_check_programs_torch_full_matrix_clean():
    """Lint and contracts for all 4 envs x both kinds, the kernel dtype
    and stream programs, and the compile check (~45 s)."""
    from tools import check_programs_torch
    findings = (check_programs_torch.run_contracts([], list(programs.KINDS),
                                                   "cpu")
                + check_programs_torch.run_recompile("cpu")
                + check_programs_torch.run_lint())
    assert findings == [], "\n".join(
        report.format_finding(f, github=False) for f in findings)
