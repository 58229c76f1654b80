"""The port's overlapped GS collect (``repro_torch.distributed.
async_collect``) and its staleness machinery through the public
``DIALSTrainer.run``, held to the contracts of
``tests/test_async_collect.py`` and, once, to the reference's async loop
driver.

* ``AsyncCollector`` primes with a blocking collect, harvests the
  in-flight collect (blocking) before any force-sync, force-syncs a
  harvest older than the bound, and keeps one collect in flight; an
  exception in its worker reaches the driver, with no serial fallback;
* ``max_aip_staleness=0`` is the serial run bit for bit; the steady
  state trains round k on the tag k-1 dataset (``data_round``
  ``[0, 0, 1]``); the untrained ablation's returns equal the serial
  run's; two runs agree bit for bit; stragglers are force-refreshed past
  the bound and kept within it;
* a run stopped after round r's record and resumed from its checkpoint
  re-primes the in-flight collect and matches the uninterrupted run bit
  for bit; without the step that held the submit params, it force-syncs;
* against the reference (``shards=1, async_collect=True,
  max_aip_staleness=2``, the tiny traffic config): the same
  ``data_round`` and ``forced_sync``; CE within 1e-5, returns within
  1e-6, params within 1e-5 (the loop-parity tolerances of
  ``tests/test_torch_dials.py``).
"""
import shutil
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal, tree_maxdiff
from repro.core import dials as jdials
from repro.core import influence as jinf
from repro.envs import registry as jreg
from repro.marl import policy as jpol
from repro.marl import ppo as jppo
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import dials, influence
from repro_torch.distributed import async_collect
from repro_torch.envs import registry
from repro_torch.marl import policy, ppo

ENV = dict(horizon=16)
POLICY = dict(hidden=(16,))
AIP = dict(kind="fnn", hidden=(16,), epochs=2, batch=16)
PPO = dict(epochs=1, minibatches=2)
DIALS = dict(aip_refresh=2, collect_envs=2, collect_steps=16, n_envs=2,
             rollout_steps=8, eval_episodes=2)


def build_trainer(**kw):
    mod, cfg = registry.make("traffic", **ENV)
    info = cfg.info()
    kw.setdefault("outer_rounds", 3)
    return dials.DIALSTrainer(
        mod, cfg, policy.PolicyConfig(info.obs_dim, info.n_actions, **POLICY),
        influence.AIPConfig(info.alsh_dim, info.n_influence, **AIP),
        ppo.PPOConfig(**PPO), dials.DIALSConfig(**DIALS, **kw),
        device="cpu")


def final(state):
    return {"p": state["ials"]["params"], "a": state["aips"]}


# ---------------------------------------------------------------------------
# AsyncCollector mechanics (a controllable fake collect)
# ---------------------------------------------------------------------------
class _FakeCollect:
    """Echoes (params, key) and counts calls; ``release`` can hold a
    background collect back."""

    def __init__(self):
        self.calls = 0
        self.release = threading.Event()
        self.release.set()

    def __call__(self, params, key):
        self.release.wait(timeout=30)
        self.calls += 1
        return {"params": params, "key": key}


def test_collector_primes_then_pipelines():
    fake = _FakeCollect()
    c = async_collect.AsyncCollector(fake, mode="thread")
    d0, forced = c.obtain(0, 10.0, 0, max_staleness=2)
    assert forced and d0.round == 0 and fake.calls == 1       # prime
    c.submit(11.0, 1, round=0)
    assert c.pending_round == 0 and not c.idle()
    d1, forced = c.obtain(1, 11.0, 1, max_staleness=2)
    assert d1.round == 0 and d1.data["params"] == 11.0
    assert not forced                                         # harvested
    assert c.idle() and c.pending_round is None
    assert c.last_obtain_wait_s >= 0.0
    c.close()


def test_collector_barrier_blocks_until_inflight_slot_ready():
    """obtain() BLOCKS on the in-flight collect rather than reusing older
    data: which dataset trains round r depends on r alone."""
    fake = _FakeCollect()
    c = async_collect.AsyncCollector(fake, mode="thread")
    c.obtain(0, 0.0, 0, max_staleness=2)                      # tag 0
    fake.release.clear()
    c.submit(1.0, 1, round=0)
    out = {}
    t = threading.Thread(target=lambda: out.update(zip(
        ("d", "forced"), c.obtain(1, 1.0, 1, max_staleness=2))))
    t.start()
    t.join(timeout=0.5)
    assert t.is_alive(), "obtain() must wait for the in-flight collect"
    fake.release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["d"].round == 0 and not out["forced"]
    assert out["d"].data["params"] == 1.0
    assert fake.calls == 2 and c.idle()
    c.close()


def test_collector_force_syncs_when_harvest_still_too_old():
    fake = _FakeCollect()
    c = async_collect.AsyncCollector(fake, mode="thread")
    c.obtain(0, 0.0, 0, max_staleness=0)
    c.submit(1.0, 1, round=0)
    d, forced = c.obtain(1, 1.0, 1, max_staleness=0)
    assert forced and d.round == 1 and d.data["params"] == 1.0
    assert c.idle() and fake.calls == 3     # prime + discarded bg + sync
    c.close()


def test_collector_single_inflight_slot():
    fake = _FakeCollect()
    c = async_collect.AsyncCollector(fake, mode="thread")
    c.submit(0.0, 0, round=0)
    with pytest.raises(RuntimeError, match="in flight"):
        c.submit(1.0, 1, round=1)
    c.close()


def test_collector_worker_failure_reaches_the_driver():
    """An exception in the worker is raised by obtain() and by run():
    nothing falls back to the serial collect."""
    def broken(params, key):
        raise ValueError("collect failed")

    c = async_collect.AsyncCollector(broken, mode="thread")
    c.submit(0.0, 0, round=0)
    with pytest.raises(ValueError, match="collect failed"):
        c.obtain(1, 0.0, 0, max_staleness=2)
    c.close()

    tr = build_trainer(async_collect=True)
    into = tr._ring._into

    def fails_on_worker(bufs, params, key):
        if threading.current_thread().name.startswith("gs-collect"):
            raise ValueError("collect failed on the worker")
        return into(bufs, params, key)

    tr._ring._into = fails_on_worker
    with pytest.raises(ValueError, match="on the worker"):
        tr.run(R.key(0))


def test_collector_refuses_the_sharded_modes():
    for kw in (dict(mode="dispatch"), dict(spare_device="cpu")):
        with pytest.raises(NotImplementedError, match="item 9"):
            async_collect.AsyncCollector(_FakeCollect(), **kw)
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        async_collect.AsyncCollector(_FakeCollect(), mode="process")


# ---------------------------------------------------------------------------
# the schedule through DIALSTrainer.run
# ---------------------------------------------------------------------------
def test_async_staleness_zero_is_bitwise_serial():
    s1, h1 = build_trainer().run(R.key(0))
    s2, h2 = build_trainer(async_collect=True,
                           max_aip_staleness=0).run(R.key(0))
    for k in ("gs_return", "aip_ce_before", "aip_ce_after", "ials_reward"):
        assert [r[k] for r in h1] == [r[k] for r in h2], k
    assert all(r["forced_sync"] for r in h2)
    assert [r["data_round"] for r in h2] == [r["round"] for r in h2]
    assert_tree_equal(final(s1), final(s2))


def test_async_steady_state_has_one_round_lag():
    _, hist = build_trainer(async_collect=True).run(R.key(0))
    assert [r["data_round"] for r in hist] == [0, 0, 1]
    assert [r["forced_sync"] for r in hist] == [True, False, False]
    # the async record: collect_s is the obtain wait, no env-step rate
    assert all(r["collect_s"] >= 0.0 and r["env_steps_per_s"] is None
               for r in hist)
    _, serial = build_trainer().run(R.key(0))
    assert [r["data_round"] for r in serial] == [0, 1, 2]
    assert all(r["env_steps_per_s"] > 0 for r in serial)
    # round 0 primes with the serial round-0 collect: the same record
    for k in ("gs_return", "aip_ce_after", "ials_reward"):
        assert hist[0][k] == serial[0][k], k


def test_async_untrained_histories_match_serial_exactly():
    _, h1 = build_trainer(untrained=True).run(R.key(0))
    _, h2 = build_trainer(untrained=True,
                          async_collect=True).run(R.key(0))
    assert [r["gs_return"] for r in h1] == [r["gs_return"] for r in h2]
    assert [r["ials_reward"] for r in h1] == [r["ials_reward"] for r in h2]


def test_async_run_is_deterministic():
    s1, h1 = build_trainer(async_collect=True).run(R.key(0))
    s2, h2 = build_trainer(async_collect=True).run(R.key(0))
    assert [r["gs_return"] for r in h1] == [r["gs_return"] for r in h2]
    assert [r["aip_ce_after"] for r in h1] == \
        [r["aip_ce_after"] for r in h2]
    assert [r["data_round"] for r in h1] == [r["data_round"] for r in h2]
    assert_tree_equal(final(s1), final(s2))


def test_straggler_force_refreshed_past_staleness_bound():
    trainer = build_trainer(outer_rounds=4, max_aip_staleness=1)
    state0 = trainer.init(R.key(0))
    mask = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    state, hist = trainer.run(R.key(0), straggler_mask=lambda rnd: mask)
    assert [r["stale_forced"] for r in hist] == [0, 1, 0, 1]
    w0 = state0["aips"]["heads"]["w"][0]
    assert not torch.allclose(w0, state["aips"]["heads"]["w"][0])


def test_straggler_within_bound_keeps_old_aips():
    trainer = build_trainer(outer_rounds=2)
    state0 = trainer.init(R.key(0))
    state, hist = trainer.run(
        R.key(0), straggler_mask=lambda rnd: np.zeros(4, np.float32))
    assert [r["stale_forced"] for r in hist] == [0, 0]
    assert_tree_equal(state0["aips"], state["aips"])


# ---------------------------------------------------------------------------
# checkpoint-resume under the async collect
# ---------------------------------------------------------------------------
class _Stop(Exception):
    pass


def _stop_at(round_):
    """A ``log`` callback that stops the run at ``round_``'s record: the
    driver logs before it saves, so step ``round_`` is the newest on
    disk, with ``async_round == round_ - 1``."""
    def log(rec):
        if rec["round"] == round_:
            raise _Stop
    return log


def _interrupt(ck, round_, **kw):
    tr = build_trainer(ckpt_dir=ck, ckpt_keep=10, **kw)
    with pytest.raises(_Stop):
        tr.run(R.key(0), log=_stop_at(round_))
    tr.manager.wait()
    return tr


def test_async_resume_matches_uninterrupted_run(tmp_path):
    kw = dict(async_collect=True, max_aip_staleness=2, outer_rounds=4)
    s_ref, h_ref = build_trainer(**kw).run(R.key(0))
    ck = str(tmp_path / "ck")
    first = _interrupt(ck, 2, **kw)
    assert first.manager.steps() == [1, 2]
    resumed = build_trainer(ckpt_dir=ck, ckpt_keep=10, **kw)
    s_res, h_res = resumed.run(R.key(0))
    assert resumed._resume_extra["async_round"] == 1
    assert [r["round"] for r in h_res] == [2, 3]
    assert [r["forced_sync"] for r in h_res] == [False, False]
    assert [r["data_round"] for r in h_res] == \
        [r["data_round"] for r in h_ref[2:]] == [1, 2]
    for r1, r2 in zip(h_ref[2:], h_res):
        for k in ("gs_return", "aip_ce_before", "aip_ce_after",
                  "ials_reward"):
            assert r1[k] == r2[k], (k, r1, r2)
    assert_tree_equal(final(s_ref), final(s_res))


def test_async_resume_force_syncs_when_reprime_impossible(tmp_path):
    kw = dict(async_collect=True, max_aip_staleness=2, outer_rounds=4)
    ck = str(tmp_path / "ck")
    _interrupt(ck, 3, **kw)
    # step 3's async_round is 2: without step 2 the re-prime is impossible
    shutil.rmtree(str(tmp_path / "ck" / "step_2"))
    _, h_res = build_trainer(ckpt_dir=ck, ckpt_keep=10, **kw).run(R.key(0))
    assert [r["round"] for r in h_res] == [3]
    assert h_res[0]["forced_sync"] and h_res[0]["data_round"] == 3


# ---------------------------------------------------------------------------
# against the reference's async loop driver
# ---------------------------------------------------------------------------
def test_async_loop_driver_matches_reference():
    jmod, jcfg = jreg.make("traffic", **ENV)
    info = jcfg.info()
    jtr = jdials.DIALSTrainer(
        jmod, jcfg,
        jpol.PolicyConfig(info.obs_dim, info.n_actions, use_kernels="off",
                          **POLICY),
        jinf.AIPConfig(info.alsh_dim, info.n_influence, use_kernels="off",
                       **AIP),
        jppo.PPOConfig(use_kernels="off", **PPO),
        jdials.DIALSConfig(shards=1, use_kernels="off", outer_rounds=3,
                           async_collect=True, max_aip_staleness=2,
                           **DIALS))
    key = jax.random.PRNGKey(0)
    state0 = jax.device_get(jtr.init(key))
    jstate, jhist = jtr.run(key)

    tr = build_trainer(async_collect=True, max_aip_staleness=2)
    tstate, thist = tr.run(R.key(0),
                           state=convert.from_jax_state(state0, "cpu"))
    for k in ("round", "data_round", "forced_sync", "stale_forced"):
        assert [r[k] for r in jhist] == [r[k] for r in thist], k
    assert [r["data_round"] for r in thist] == [0, 0, 1]
    for jrec, trec in zip(jhist, thist):
        for k, tol in (("aip_ce_before", 1e-5), ("aip_ce_after", 1e-5),
                       ("gs_return", 1e-6), ("ials_reward", 1e-6)):
            assert abs(jrec[k] - trec[k]) <= tol, (k, jrec[k], trec[k])
    assert tree_maxdiff(jstate["ials"]["params"],
                        tstate["ials"]["params"]) < 1e-5
    assert tree_maxdiff(jstate["aips"], tstate["aips"]) < 1e-5


# ---------------------------------------------------------------------------
# state the collect worker shares with the driver
# ---------------------------------------------------------------------------
def _hammer(fn, n_threads=8):
    """``fn()`` from ``n_threads`` threads at once, with the interpreter
    switching threads as often as it can."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fn) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_gru_launch_counts_lose_no_update(monkeypatch):
    """The GRU wrappers' counts, updated from the driver and the collect
    worker: 8 threads x 2000 counts, none lost, split by stream."""
    from repro_torch.kernels.gru import kernel as gk
    monkeypatch.setattr(gk, "LAUNCHES", {"gru_forward": 0,
                                         "gru_backward": 0})
    monkeypatch.setattr(gk, "SHAPE_LAUNCHES", {"gru_forward": {},
                                               "gru_backward": {}})
    monkeypatch.setattr(gk, "STREAM_LAUNCHES", {"gru_forward": {},
                                                "gru_backward": {}})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: (
        types.SimpleNamespace(cuda_stream=threading.get_ident() % 2)))

    def count():
        for _ in range(2000):
            gk._count("gru_forward", (1, 2, 3, 4), "cuda:0")

    _hammer(count)
    assert gk.LAUNCHES["gru_forward"] == 16000
    assert gk.SHAPE_LAUNCHES["gru_forward"] == {(1, 2, 3, 4): 16000}
    assert sum(gk.STREAM_LAUNCHES["gru_forward"].values()) == 16000


def test_kernel_build_runs_once_under_threads(monkeypatch):
    """Two threads reaching the first kernel build: one build."""
    from torch.utils import cpp_extension
    from repro_torch.kernels import build
    calls = []

    def fake_load(**kw):
        calls.append(kw["name"])
        time.sleep(0.01)
        return object()

    monkeypatch.setattr(build, "_extension", None)
    monkeypatch.setattr(build.BUILD_DIR.__class__, "mkdir",
                        lambda self, **kw: None)
    monkeypatch.setattr(cpp_extension, "load", fake_load)
    got = []
    _hammer(lambda: got.append(build.extension()))
    assert calls == [build.NAME] and len(got) == 8
    assert all(x is got[0] for x in got)
