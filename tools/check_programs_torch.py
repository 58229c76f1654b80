"""Program-contract checker of the port — the port of
``tools/check_programs.py``.

Builds the port's loop-driver and sharded-round programs for every
registered scenario and policy kind at tiny sizes
(``repro_torch.analysis.programs``), runs the
``repro_torch.analysis.contracts`` rule set over them, runs the sharded
round's programs again on two spawned ranks of one gloo group
(``CollectiveFree``, ``HaloOnly``), runs the AST lint over the port's
runtime modules and one tiny run of the loop driver under the compile
counter to assert zero steady-state compiles. Findings print through
``repro_torch.analysis.report.format_finding``: ``file:line`` locally,
``::error`` annotations under GitHub Actions. Exit 1 on any finding.

It runs on the card (where ``NoHostSync`` also runs under the
sync-debug mode and ``GraphCapturable`` captures every program as a
CUDA graph) and raises without one unless given ``--device cpu``.

    PYTHONPATH=src python -m tools.check_programs_torch              # all
    PYTHONPATH=src python -m tools.check_programs_torch --device cpu
    PYTHONPATH=src python -m tools.check_programs_torch --lint       # lint
    PYTHONPATH=src python -m tools.check_programs_torch --contracts \\
        --scenarios traffic --kinds fnn,gru
    PYTHONPATH=src python -m tools.check_programs_torch --census    # ops
        # per program and their ten busiest source lines
    PYTHONPATH=src python -m tools.check_programs_torch --sharded \
        --scenarios traffic            # the sharded round on two ranks
        # (the ranks share the one card, or the CPU)
    PYTHONPATH=src python -m tools.check_programs_torch --selftest  # the
        # deliberately broken fixtures must each FAIL their own rule
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

# the sharded pass's ranks: the fewest that make a ring with neighbours
SHARDED_RANKS = 2


def _rel(findings):
    """Repo-relative finding paths, so CI annotations land on files."""
    out = []
    for f in findings:
        if f.file and os.path.isabs(f.file):
            f = dataclasses.replace(f, file=os.path.relpath(f.file,
                                                            REPO_ROOT))
        out.append(f)
    return out


def run_contracts(scenarios, kinds, device) -> list:
    from repro_torch.analysis import contracts, programs
    progs = programs.all_programs(scenarios or None, kinds, device=device)
    print(f"# check_programs_torch: {len(progs)} programs on {device} "
          f"({', '.join(scenarios) if scenarios else 'all scenarios'} x "
          f"{', '.join(kinds)})")
    if str(device) == "cpu":
        print("# check_programs_torch: GraphCapturable runs on a card only")
    return contracts.run_rules(progs)


def run_census(scenarios, kinds, device) -> None:
    from repro_torch.analysis import programs, walker
    from repro_torch.envs import registry
    for env in scenarios or registry.names():
        for kind in kinds:
            for p in programs.loop_programs(env, kind=kind, device=device):
                rec = p.recording()
                top = ", ".join(f"{loc} {n}"
                                for loc, n in walker.census(rec, 10))
                fns = ", ".join(f"{fn} {n / len(rec.sites):.3f}" for fn, n
                                in walker.census(rec, 3, by="fn"))
                print(f"census {p.name} [{kind}]: {len(rec.sites)} ops, "
                      f"{len(walker.host_reads(rec))} host reads; "
                      f"top lines: {top}; top functions (share): {fns}")


def _sharded_rank(scenarios, kinds, device) -> list:
    """One rank of the sharded scenario: every scenario x kind's sharded
    programs on this rank's shard, checked by the communication rules."""
    import torch
    from repro_torch.analysis import contracts, programs
    from repro_torch.distributed import bootstrap
    from repro_torch.envs import registry
    ctx = bootstrap.bootstrap()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ctx.num_processes))
    findings = []
    for env in scenarios or registry.names():
        for kind in kinds:
            progs = programs.sharded_programs(env, kind=kind, device=device)
            findings += contracts.run_rules(
                progs, rules=(contracts.CollectiveFree(),
                              contracts.HaloOnly()))
            if ctx.is_primary:
                print(f"# check_programs_torch: sharded {env}[{kind}] on "
                      f"{ctx.num_processes} ranks: "
                      f"{', '.join(p.name for p in progs)}", flush=True)
    return findings


def run_sharded(scenarios, kinds, device) -> list:
    """The sharded round's programs on SHARDED_RANKS local ranks of one
    gloo group (``bootstrap.spawn_local``); every rank's findings."""
    from repro_torch.distributed import bootstrap
    print(f"# check_programs_torch: sharded programs on {SHARDED_RANKS} "
          f"ranks ({device})", flush=True)
    per_rank = bootstrap.spawn_local(SHARDED_RANKS, _sharded_rank,
                                     scenarios, kinds, str(device))
    return [f for found in per_rank for f in found]


def run_lint() -> list:
    from repro_torch.analysis import lint
    targets = lint.default_targets(os.path.join(REPO_ROOT, "src",
                                                "repro_torch"))
    print(f"# check_programs_torch: linting {len(targets)} runtime modules")
    return lint.lint_paths(targets)


def run_recompile(device) -> list:
    """One tiny run of the loop driver under the compile counter: no
    compile after the warm-up round (3 rounds, so the steady state is
    observed twice)."""
    from repro_torch import random as R
    from repro_torch.analysis import programs, recompile
    trainer = programs.tiny_trainer("traffic", device=device, shards=1,
                                    outer_rounds=3)
    counts = []
    with recompile.CompileCounter() as cc:
        trainer.run(R.key(0, device=trainer.device),
                    log=lambda rec: counts.append(cc.count))
    print(f"# check_programs_torch: loop driver compile counts per round: "
          f"{counts}")
    return recompile.check_steady_state(counts, what="loop driver")


@contextlib.contextmanager
def _one_process_group():
    """A one-process gloo group on an in-memory store, for the fixtures
    that dispatch real c10d ops; the group already up, if there is one."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def selftest_failures(device) -> list:
    """The gate must still be able to fail: each deliberately broken
    fixture must produce a finding of its own rule, with provenance
    where the rule gives one. Returns the fixtures that did not fail."""
    import torch
    import torch.distributed
    from repro_torch.analysis import contracts, lint, recompile, walker
    from repro_torch.obs.trace import annotate
    from repro_torch.obs import metrics

    failures = []
    dev = torch.device(device)
    x = torch.ones(8, device=dev)

    def rule_of(rule, program):
        return [f for f in rule.check(program) if f.rule == rule.name]

    def synced(v):
        return v * float(v.sum())                  # a host read

    found = rule_of(contracts.NoHostSync(), contracts.Program(
        "selftest/host-read", ("program",), synced, (x,)))
    if not (found and found[0].line
            and found[0].file.endswith("check_programs_torch.py")):
        failures.append("host-read fixture did not fail NoHostSync with "
                        "provenance")

    def range_read(v):
        return v + v.min().item()                  # not a one_hot check

    if not rule_of(contracts.NoHostSync(), contracts.Program(
            "selftest/min-item", ("program",), range_read, (x,))):
        failures.append("a min().item() outside one_hot was exempted")

    found = rule_of(contracts.DtypeRoundTrip(), contracts.Program(
        "selftest/upcast", ("dtype",), lambda v: v.float() * 2,
        (x.to(torch.bfloat16),)))
    if not found:
        failures.append("upcast fixture did not fail DtypeRoundTrip")

    slot = {"feats": torch.zeros((2, 2, 4, 3), device=dev),
            "resets": torch.zeros((2, 2, 4), device=dev)}

    def reallocating(bufs):
        steps = [torch.ones((2, 2, 3), device=dev) for _ in range(4)]
        return {"feats": torch.stack(steps, dim=2),
                "resets": bufs["resets"]}

    found = rule_of(contracts.RingBufferResident(), contracts.Program(
        "selftest/realloc", ("ring_collect",), reallocating, (slot,)))
    if not (found and any(f.line for f in found)):
        failures.append("reallocating collect did not fail "
                        "RingBufferResident with provenance")

    rec = {k: 0.0 for k in metrics.ROUND_KEYS}
    found = rule_of(contracts.ScalarSyncBudget(), contracts.Program(
        "selftest/record", ("round",),
        meta={"record": {**rec, "surprise": 1.0,
                         "gs_return": torch.zeros(())}}))
    if len(found) < 2:
        failures.append("off-schema record did not fail ScalarSyncBudget")

    def gathering(v):
        parts = [torch.empty_like(v)]
        torch.distributed.all_gather(parts, v)     # dispatches c10d ops
        return parts[0] * 2

    with _one_process_group():
        found = rule_of(contracts.CollectiveFree(), contracts.Program(
            "selftest/collective", ("train_body",), gathering, (x,)))
        if not (found and found[0].line
                and found[0].file.endswith("check_programs_torch.py")):
            failures.append("a collective in the train body did not fail "
                            "CollectiveFree with provenance")
        if not rule_of(contracts.HaloOnly(), contracts.Program(
                "selftest/gather-in-gs", ("gs_body",), gathering, (x,))):
            failures.append("an all_gather in a GS body did not fail "
                            "HaloOnly")
        if not rule_of(contracts.HaloOnly(), contracts.Program(
                "selftest/silent-gs", ("gs_body",), lambda v: v * 2,
                (x,))):
            failures.append("a one-shard GS body without a halo exchange "
                            "did not fail HaloOnly")

    if dev.type == "cuda":
        found = rule_of(contracts.GraphCapturable(), contracts.Program(
            "selftest/sync-in-graph", ("program",), synced, (x,)))
        if not (found and found[0].line):
            failures.append("a syncing program did not fail "
                            "GraphCapturable with provenance")

    found = lint.lint_source(
        "from repro_torch import random as R\n"
        "def f(key):\n"
        "    a = R.normal(key, (3,))\n"
        "    b = R.uniform(key, (3,))\n"
        "    return a + b\n", filename="selftest_reuse.py")
    if not (found and found[0].rule == "prng-reuse" and found[0].line):
        failures.append("reused-key fixture did not fail prng-reuse with "
                        "provenance")
    found = lint.lint_source(
        "def f(x):\n"
        "    def inner(y):\n"
        "        return y * float(y.sum())\n"
        "    return inner(x)\n", filename="selftest_sync.py")
    if not any(f.rule == "host-sync-branch" for f in found):
        failures.append("host read in a nested function did not fail "
                        "host-sync-branch")
    found = lint.lint_source("import torch\nx = torch.rand(3)\n",
                             filename="selftest_rng.py")
    if not any(f.rule == "torch-global-rng" for f in found):
        failures.append("global-RNG fixture did not fail torch-global-rng")

    def labelled(v):
        with annotate("selftest_span"):
            return v * 2

    sites = walker.sites(walker.record(labelled, x), ["aten.mul"])
    if not (sites and sites[0].labels == ("selftest_span",)
            and sites[0].file and sites[0].line):
        failures.append("walker lost label/source provenance")

    if not recompile.check_steady_state([0, 1], what="selftest"):
        failures.append("a compile after round 0 did not fail "
                        "SteadyStateCompile")
    return failures


def run_selftest(device) -> int:
    failures = selftest_failures(device)
    for msg in failures:
        print(f"SELFTEST-FAIL {msg}")
    print("# check_programs_torch --selftest: "
          + ("FAIL" if failures else "OK (all broken fixtures fail)"))
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--contracts", action="store_true",
                    help="run the contract pass")
    ap.add_argument("--lint", action="store_true",
                    help="run the AST lint pass")
    ap.add_argument("--census", action="store_true",
                    help="print each loop program's op count and its ten "
                         "busiest source lines")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the gate fails on broken fixtures")
    ap.add_argument("--sharded", action="store_true",
                    help="run the sharded round's programs on two "
                         "spawned ranks")
    ap.add_argument("--scenarios", default="",
                    help="comma-separated env names (default: all "
                         "registered)")
    ap.add_argument("--kinds", default="fnn,gru",
                    help="comma-separated policy kinds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the programs run (default: the card; "
                         "raises without one)")
    args = ap.parse_args()

    from repro_torch.kernels.dispatch import resolve_device
    lint_only = args.lint and not (args.contracts or args.census
                                   or args.selftest or args.sharded)
    device = None if lint_only else resolve_device(args.device)
    if args.selftest:
        return run_selftest(device)

    from repro_torch.analysis.report import emit
    scenarios = [s for s in args.scenarios.split(",") if s]
    kinds = [k for k in args.kinds.split(",") if k]
    everything = not (args.contracts or args.lint or args.census
                      or args.sharded)
    findings = []
    if args.census:
        run_census(scenarios, kinds, device)
    if everything or args.contracts:
        findings += run_contracts(scenarios, kinds, device)
        findings += run_recompile(device)
    if everything or args.sharded:
        findings += run_sharded(scenarios, kinds, device)
    if everything or args.lint:
        findings += run_lint()
    n = emit(_rel(findings))
    if n:
        print(f"# check_programs_torch: {n} violation(s)")
        return 1
    print("# check_programs_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
