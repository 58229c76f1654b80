"""The sharded DIALS round (``repro_torch.core.dials_sharded``) on two and
four gloo ranks on the CPU, started by ``bootstrap.spawn_local``, against
the port's loop driver in process (itself held to the reference's loop
driver by ``tests/test_torch_dials.py``).

Each scenario's ranks run ``DIALSConfig(shards=n)`` twice from the same
seed, collect once more and audit the round's programs; the parent holds
rank 0's records and final state to the loop run. Tolerances: AIP params
1e-6, held-out CE 1e-5 and GS return 5e-2, the reference's for a sharded
round against the loop (``tests/_multidevice_check.py``); the IALS reward
1e-5, as the CE; policy params 1e-6, not the reference's 1e-2: the tiny
run's 8 optimizer steps move no parameter more than about 2e-3 from its
init, so 1e-2 would pass a skipped update, and the ranks on the CPU stay
within 2e-7 of the loop. Bit for bit: each rank's collect against the
replicated collect's rows, and the second run against the first.

This file imports no JAX, so a rank (a fresh ``spawn`` process that
imports it to find its job) starts in a few seconds. Each scenario's
ranks are started once per test process (:func:`_spawned`): the
straggler test reads the two traffic ranks' second job.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.analysis import contracts, programs
from repro_torch.core import dials, dials_sharded
from repro_torch.distributed import bootstrap, collectives, runtime
from repro_torch.tree import leaves

TOL = {"aips": 1e-6, "policy": 1e-6, "aip_ce_before": 1e-5,
       "aip_ce_after": 1e-5, "gs_return": 5e-2, "ials_reward": 1e-5}
TIMEOUT_S = 300
# (env, ranks, region-decomposed GS): traffic's 2x2 grid tiles 2 row
# bands but not 4, so at 4 ranks sharded_gs=auto falls back to the
# replicated GS; powergrid's ring tiles any count
SCENARIOS = [("traffic", 2, True), ("powergrid", 4, True),
             ("traffic", 4, False)]
STRAGGLER = np.array([0.0, 1.0, 1.0, 1.0], np.float32)


def _timeless(history):
    return [{k: v for k, v in rec.items() if k not in ("round_s", "wall_s")}
            for rec in history]


def _state_leaves(state):
    return {"aips": leaves(state["aips"]),
            "params": leaves(state["ials"]["params"])}


def _rank_job(env, n):
    """One rank: two runs of the same seed, a collect against the
    replicated collect's rows, the round's contracts, a GS body that
    all-reduces (HaloOnly must fail it), the one-shard-per-rank refusal
    and the collective wrappers; on two traffic ranks also the straggler
    run (:func:`_straggler_run`)."""
    torch.set_num_threads(1)
    ctx = bootstrap.bootstrap()
    tr = programs.tiny_trainer(env, device="cpu", shards=n)
    s1, h1 = tr.run(R.key(0))
    s2, h2 = tr.run(R.key(0))
    runner = tr._sharded
    init = tr.init(R.key(0))
    carry = runner.shard_carry(
        {"aips": init["aips"], "ials": init["ials"],
         "reports": torch.zeros(tr.info.n_agents, dtype=torch.int64)})
    mine = runner.collect(carry["ials"]["params"], R.key(5))
    full = tr.collect(init["ials"]["params"], R.key(5))
    runner.audit_collectives(carry, R.key(0))
    leaky = []
    if runner.use_sharded_gs:
        def leaky_eval(params, key):
            ret = runner.gs_eval.body(params, key, 2)
            return collectives.tree_psum(ret, runner.mesh)
        leaky = [f.message for f in contracts.HaloOnly().check(
            contracts.Program("leaky gs_eval", ("gs_body",), leaky_eval,
                              (carry["ials"]["params"], R.key(1))))]
    try:
        runtime.shard_mesh(1, device="cpu")
        mesh_refused = False
    except ValueError:
        mesh_refused = True
    mesh, r = runner.mesh, float(ctx.process_id)
    x = torch.arange(2.0 * n) + 10 * r
    coll = {"psum": collectives.tree_psum(x, mesh),
            "pmean": collectives.tree_pmean(x, mesh),
            "gather": collectives.tree_all_gather({"x": x[None]},
                                                  mesh)["x"],
            "scatter": collectives.tree_psum_scatter(x, mesh),
            "bcast": collectives.pbroadcast([x], mesh, root=n - 1)[0],
            "ring": collectives.ppermute_ring(x, mesh, shift=1),
            "x": x}
    out = {"rank": ctx.process_id, "world": ctx.num_processes,
           "use_sharded_gs": runner.use_sharded_gs,
           "n_shards": [r["n_shards"] for r in h1],
           "again_equal": (_timeless(h1) == _timeless(h2) and all(
               torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2))
               if isinstance(a, torch.Tensor))),
           "collect_equal": sorted(mine) == sorted(full) and all(
               torch.equal(mine[k], full[k][runner.rows]) for k in full),
           "halo": dict(collectives.STATS), "leaky": leaky,
           "mesh_refused": mesh_refused, "history": h1, "coll": coll}
    if ctx.process_id == 0:
        out["state"] = _state_leaves(s1)
    if (env, n) == ("traffic", 2):
        out["straggler"] = _straggler_run(n)
    return out


def _straggler_run(n):
    """Traffic on ``n`` ranks, bound 1: agent 0 never refreshes on
    time."""
    tr = programs.tiny_trainer("traffic", device="cpu", shards=n,
                               max_aip_staleness=1)
    state, history = tr.run(R.key(0), straggler_mask=lambda rnd: STRAGGLER)
    return {"history": history, "state": _state_leaves(state)}


@functools.lru_cache(maxsize=None)
def _spawned(env, n):
    """The ranks' outputs of one scenario, by rank (started once)."""
    return bootstrap.spawn_local(n, _rank_job, env, n, timeout_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _loop_run(env):
    """The loop driver's run of ``env`` in this process (the scenarios of
    one env share it)."""
    return programs.tiny_trainer(env, device="cpu", shards=1).run(R.key(0))


def _assert_matches_loop(out, loop_state, loop_history):
    got, want = out["state"], _state_leaves(loop_state)
    for part, tol in (("aips", TOL["aips"]), ("params", TOL["policy"])):
        err = max(float(np.abs(np.asarray(a, np.float64)
                               - b.double().numpy()).max())
                  for a, b in zip(got[part], want[part]))
        assert err <= tol, (part, err)
    assert len(out["history"]) == len(loop_history)
    for rec, ref in zip(out["history"], loop_history):
        for k in ("aip_ce_before", "aip_ce_after", "gs_return",
                  "ials_reward"):
            assert abs(rec[k] - ref[k]) <= TOL[k], (k, rec[k], ref[k])
        for k in ("round", "data_round", "stale_forced", "staleness_min",
                  "staleness_max"):
            assert rec[k] == ref[k], k
        assert (rec["collect_s"], rec["aip_s"], rec["reassigned"],
                rec["dead_hosts"]) == (None, None, 0, [])


def _assert_collectives(got, xs, rank):
    """The collective wrappers on every rank's x (this rank's ``rank``)
    against numpy: sum, mean, stacked gather, this rank's slice of the
    sum, the last rank's x, the previous rank's x."""
    n, total = len(xs), np.sum(xs, axis=0)
    chunk = len(total) // n
    want = {"psum": total, "pmean": total / n,
            "gather": np.stack(xs),
            "scatter": total[rank * chunk:(rank + 1) * chunk],
            "bcast": xs[-1], "ring": xs[(rank - 1) % n]}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=0, err_msg=k)


@pytest.mark.parametrize("env,n,sharded_gs", SCENARIOS,
                         ids=[f"{e}-{n}" for e, n, _ in SCENARIOS])
def test_ranks_match_loop_driver(env, n, sharded_gs):
    outs = _spawned(env, n)
    assert [o["rank"] for o in outs] == list(range(n))
    _assert_matches_loop(outs[0], *_loop_run(env))
    for o in outs:
        assert o["world"] == n and o["n_shards"] == [n, n]
        assert o["use_sharded_gs"] is sharded_gs
        assert o["again_equal"], f"rank {o['rank']}: not deterministic"
        assert o["collect_equal"], f"rank {o['rank']}: collect differs"
        assert o["mesh_refused"]
        assert _timeless(o["history"]) == _timeless(outs[0]["history"])
        _assert_collectives(o["coll"], [p["coll"]["x"] for p in outs],
                            o["rank"])
        if sharded_gs:
            assert o["halo"]["halo_exchanges"] > 0
            assert o["halo"]["p2p_calls"] > 0
            assert o["halo"]["staged_bytes"] == 0       # CPU tensors
            assert any("non-halo collective" in m and "allreduce" in m
                       for m in o["leaky"]), o["leaky"]
        else:
            assert o["halo"]["halo_exchanges"] == 0


def test_straggler_mask_on_two_ranks():
    """A late agent keeps its old AIP within the bound and is
    force-refreshed past it (``stale_forced`` [0, 1]), on two ranks as
    in the loop driver under the same mask."""
    outs = [o["straggler"] for o in _spawned("traffic", 2)]
    tr = programs.tiny_trainer("traffic", device="cpu", shards=1,
                               max_aip_staleness=1)
    loop_state, loop_history = tr.run(R.key(0),
                                      straggler_mask=lambda rnd: STRAGGLER)
    assert [r["stale_forced"] for r in loop_history] == [0, 1]
    for o in outs:
        assert _timeless(o["history"]) == _timeless(outs[0]["history"])
    _assert_matches_loop(outs[0], loop_state, loop_history)


def test_sharded_refusals():
    # the async collect and checkpoints are no longer refused with
    # shards > 1 (tests/test_torch_sharded_{async,resume}.py)
    for lifted in (dict(async_collect=True), dict(ckpt_dir="unused")):
        programs.tiny_trainer("traffic", device="cpu", shards=2, **lifted)
    # one shard per process: 2 shards in a one-process "group"
    with pytest.raises(ValueError, match="one shard per rank"):
        programs.tiny_trainer("traffic", device="cpu", shards=2).run(
            R.key(0))
    with pytest.raises(ValueError, match="one shard per process"):
        runtime.shard_mesh(2, device="cpu")
    # sharded_gs='on' where the topology cannot tile (2 grid rows, 4
    # blocks), and on the loop path
    tr = programs.tiny_trainer("traffic", device="cpu", sharded_gs="on")
    mesh4 = runtime.ShardMesh(n_shards=4, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="cannot decompose into 4 blocks"):
        dials_sharded.ShardedDIALSRunner(
            tr.env_mod, tr.env_cfg, tr.policy_cfg, tr.aip_cfg, tr.ppo_cfg,
            tr.cfg, mesh=mesh4)
    with pytest.raises(ValueError, match="requires the sharded runtime"):
        tr.run(R.key(0))
    with pytest.raises(ValueError, match="auto|on|off"):
        programs.tiny_trainer("traffic", device="cpu",
                              sharded_gs="maybe")
    assert dials.DIALSConfig().shards is None
