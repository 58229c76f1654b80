"""The port's telemetry (``repro_torch.obs``) held to the contracts of
``tests/test_obs.py`` and to the reference's own code on the same
inputs:

* spans nest with their depth, ``phase_seconds`` sums and resets, a
  fence is a no-op unless the tracer is fenced and a CUDA tensor is
  given, and then waits on an event of the current stream, never on the
  whole device; the null tracer allocates nothing;
* ``round_record`` rejects drift; ``validate_round``,
  ``validate_bench_row`` and ``phase_breakdown`` give the reference's
  answers on the same rows, and the schemas are the reference's;
* the sinks write the reference's bytes; JSONL round trip, merge order
  and a truncated tail; the CSV and terminal sinks; ``DISABLED``
  creates no file; the event envelope;
* the loop driver's telemetry: observation only (the same numbers on or
  off), ``run_start``/``round``/``run_end`` (and ``collect_obtain`` with
  the async collect), and a log that passes the unchanged
  ``tools/telemetry_report.py --check``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import sinks as jsinks
from repro_torch import obs
from repro_torch import random as R
from repro_torch.core import dials, influence
from repro_torch.envs import registry
from repro_torch.marl import policy as policy_mod, ppo as ppo_mod
from repro_torch.obs import metrics, sinks, trace
from tools import telemetry_report


# ---------------------------------------------------------------------------
# trace: spans, nesting, fencing, disabled mode
# ---------------------------------------------------------------------------
def test_tracer_records_nested_spans_with_depth():
    clock = iter(range(100)).__next__
    tr = trace.Tracer(clock=lambda: float(clock()))
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    assert [e["name"] for e in tr.events] == ["inner", "outer"]
    assert [e["depth"] for e in tr.events] == [1, 0]
    by_name = {e["name"]: e for e in tr.events}
    assert by_name["inner"]["t0"] > by_name["outer"]["t0"]
    assert by_name["outer"]["dur_s"] > by_name["inner"]["dur_s"]


def test_phase_seconds_sums_per_name_and_resets():
    ticks = iter([0.0, 1.0, 10.0, 13.0, 20.0, 25.0]).__next__
    tr = trace.Tracer(clock=ticks)
    for _ in range(2):
        with tr.span("collect"):
            pass
    with tr.span("train"):
        pass
    assert tr.phase_seconds() == {"collect": 4.0, "train": 5.0}
    tr.reset()
    assert tr.events == [] and tr.phase_seconds() == {}


def test_span_fence_waits_on_the_current_stream_only(monkeypatch):
    """A fenced span with a CUDA tensor records one event on the current
    stream and synchronises it; an unfenced span, or one given only CPU
    values, touches no CUDA API; nothing calls the device-wide
    ``torch.cuda.synchronize``."""
    calls = []

    class FakeEvent:
        def record(self, stream):
            calls.append(("record", stream))

        def synchronize(self):
            calls.append(("synchronize",))

    def no_device_sync(*a, **k):
        raise AssertionError("device-wide synchronize")

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: f"stream of {device}")
    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    x = {"a": torch.ones(3), "b": [1.0]}
    for fenced in (False, True):
        with trace.Tracer(fenced=fenced).span("s") as sp:
            assert sp.fence(x) is x
    assert calls == []                      # CPU values: nothing to wait on
    monkeypatch.setattr(trace, "_cuda_device", lambda value: "cuda:0")
    with trace.Tracer().span("s") as sp:
        assert sp.fence(x) is x
    assert calls == []                      # unfenced
    with trace.Tracer(fenced=True).span("s") as sp:
        assert sp.fence(x) is x
    assert calls == [("record", "stream of cuda:0"), ("synchronize",)]


def test_null_tracer_allocates_nothing():
    tr = trace.NULL_TRACER
    assert not tr.enabled
    s1 = tr.span("a")
    assert s1 is tr.span("b")              # one shared no-op span
    with s1 as sp:
        assert sp.fence(123) == 123
    assert tr.events == [] and tr.phase_seconds() == {}


def test_profile_and_annotate(tmp_path):
    with trace.profile(None):
        pass
    with trace.profile(str(tmp_path / "prof")):
        with trace.annotate("named"):
            torch.ones(4).sum()
    events = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in events["traceEvents"]}
    assert "named" in names


# ---------------------------------------------------------------------------
# metrics: the typed round record and the benchmark rows
# ---------------------------------------------------------------------------
def _full_record(**over):
    base = dict(round=0, gs_return=np.float32(1.5), ials_reward=0.25,
                aip_ce_before=0.7, aip_ce_after=0.6, data_round=0,
                forced_sync=True, stale_forced=0, staleness_min=0,
                staleness_mean=0.0, staleness_max=0, n_shards=1,
                reassigned=0, dead_hosts=[], kernels="policy=plain",
                collect_s=0.1, env_steps_per_s=None, aip_s=None,
                inner_s=None, eval_s=None, mirror_s=None, round_s=0.5,
                wall_s=0.5)
    base.update(over)
    return base


def test_round_record_coerces_and_rejects_drift():
    rec = metrics.round_record(**_full_record(
        round=np.int64(3), gs_return=torch.tensor(2.0),
        staleness_max=torch.tensor(1), dead_hosts=[np.int64(1)]))
    assert rec == jmetrics.round_record(**_full_record(
        round=3, gs_return=2.0, staleness_max=1, dead_hosts=[1]))
    assert type(rec["round"]) is int and type(rec["gs_return"]) is float
    json.dumps(rec)
    with pytest.raises(TypeError, match="unknown"):
        metrics.round_record(**_full_record(), extra_key=1)
    partial = _full_record()
    partial.pop("gs_return")
    with pytest.raises(TypeError, match="missing"):
        metrics.round_record(**partial)
    with pytest.raises(TypeError, match="not.*nullable"):
        metrics.round_record(**_full_record(gs_return=None))
    assert metrics.round_record(
        **_full_record(ials_reward=None))["ials_reward"] is None


def test_validate_round_gives_the_reference_problems():
    good = metrics.round_record(**_full_record())
    bad = dict(good, round=True, gs_return="high", surprise=1)
    bad.pop("n_shards")
    for rec in (good, {**good, "event": "round", "proc": 0, "seq": 1,
                       "t": 0.0}, bad, dict(good, aip_ce_after=None)):
        assert metrics.validate_round(rec) == jmetrics.validate_round(rec)
    problems = "\n".join(metrics.validate_round(bad))
    assert "missing field 'n_shards'" in problems
    assert "unknown field 'surprise'" in problems
    assert metrics.ROUND_FIELDS == jmetrics.ROUND_FIELDS
    assert metrics.ROUND_PHASES == jmetrics.ROUND_PHASES
    assert metrics.ENVELOPE_FIELDS == jmetrics.ENVELOPE_FIELDS


def test_validate_bench_row_gives_the_reference_problems():
    row = {"label": "t-s1", "scenario": "t", "n_agents": 4, "shards": 1,
           "processes": 1, "streams": 4, "fused": False, "round_s": 1.0,
           "round_s_async": 0.8, "overlap_speedup": 1.25,
           "inner_steps_per_s": 100.0, "inner_steps_per_s_async": 125.0,
           "total_wall_s": 5.0, "total_wall_s_async": 4.0,
           "collect_s": 0.2, "env_steps_per_s": 640.0,
           "collect_s_sharded_gs": None, "gs_speedup": None}
    gae = {"kernel": "gae", "label": "x", "B": 4, "T": 8,
           "fwd_oracle_s": 1e-4, "fwd_kernel_s": 1e-4,
           "fwdbwd_oracle_s": 1e-4, "fwdbwd_kernel_s": 1e-4,
           "speedup_fwd": 1.0, "speedup_fwdbwd": 1.0,
           "roofline_fwd": {}, "roofline_fwdbwd": {}}
    e2e = {"program": "train_aip", "label": "w", "oracle_s": 1.0,
           "kernel_s": 0.5, "speedup": 2.0}
    cases = [(row, "SCALING_ROW_SCHEMA"),
             ({**row, "shards": "2", "mystery": 1, "round_s": None},
              "SCALING_ROW_SCHEMA"),
             (gae, "KERNELS_MICRO_SCHEMA"),
             ({**gae, "B": 4.0, "roofline_fwd": None},
              "KERNELS_MICRO_SCHEMA"),
             (e2e, "KERNELS_E2E_SCHEMA"),
             ({**e2e, "speedup": True}, "KERNELS_E2E_SCHEMA")]
    for r, name in cases:
        schema, jschema = getattr(metrics, name), getattr(jmetrics, name)
        assert schema == jschema
        assert metrics.validate_bench_row(r, schema) == \
            jmetrics.validate_bench_row(r, jschema)
        assert metrics.phase_breakdown(r, schema) == \
            jmetrics.phase_breakdown(r, jschema)
    assert metrics.validate_bench_row(row, metrics.SCALING_ROW_SCHEMA) == []
    assert "'round_s' is null" in "\n".join(metrics.validate_bench_row(
        {**row, "round_s": None}, metrics.SCALING_ROW_SCHEMA))


# ---------------------------------------------------------------------------
# sinks: the reference's bytes, round trip, merge order, truncation
# ---------------------------------------------------------------------------
def _events():
    rec = metrics.round_record(**_full_record(dead_hosts=[1, 2]))
    return [{"event": "run_start", "proc": 0, "seq": 0, "t": 1.0,
             "path": "loop"},
            {"event": "round", "proc": 0, "seq": 1, "t": 2.0, **rec},
            {"event": "collect_obtain", "proc": 0, "seq": 2, "t": 2.5,
             "round": 1, "data_round": 0, "forced": False,
             "mode": "thread", "wait_s": 0.125}]


def test_sinks_write_the_reference_bytes(tmp_path):
    for name, make, jmake in (("e.jsonl", sinks.JsonlSink, jsinks.JsonlSink),
                              ("r.csv", sinks.CsvSink, jsinks.CsvSink)):
        paths = []
        for side, factory in (("port", make), ("ref", jmake)):
            path = str(tmp_path / side / name)
            sink = factory(path)
            sinks.write_events(_events(), sink)
            sink.close()
            paths.append(path)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    lines = open(tmp_path / "port" / "r.csv").read().strip().splitlines()
    assert len(lines) == 2                       # header + one round
    assert lines[0].split(",") == ["proc"] + list(metrics.ROUND_KEYS)
    assert "1;2" in lines[1]
    assert sinks.proc_path("d", 3) == jsinks.proc_path("d", 3)


def test_jsonl_roundtrip_and_merge_order(tmp_path):
    d = str(tmp_path)
    t0 = obs.Telemetry(d, process_id=0, tracer=trace.Tracer())
    t1 = obs.Telemetry(d, process_id=1, tracer=trace.Tracer())
    t1.emit("round", **metrics.round_record(**_full_record(round=0)))
    t0.emit("run_start", path="loop")
    t0.emit("round", **metrics.round_record(**_full_record(round=0)))
    t1.emit("round", **metrics.round_record(**_full_record(round=1)))
    t0.close()
    t1.close()
    merged = sinks.merge_dir(d)
    assert merged == os.path.join(d, sinks.MERGED_NAME)
    events = sinks.read_jsonl(merged)
    assert len(events) == 4
    keys = [(e["t"], e["proc"], e["seq"]) for e in events]
    assert keys == sorted(keys)
    assert [e["seq"] for e in events if e["proc"] == 0] == [0, 1]
    assert sinks.read_jsonl(sinks.merge_dir(d)) == events   # idempotent
    # the reference merges the port's files to the same bytes
    ref = jsinks.merge_dir(d, out=str(tmp_path / "ref.jsonl"))
    assert open(ref, "rb").read() == open(merged, "rb").read()


def test_read_jsonl_tolerates_truncated_tail(tmp_path):
    path = str(tmp_path / "telemetry-p0.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"event": "round", "seq": 0}) + "\n")
        f.write(json.dumps({"event": "round", "seq": 1}) + "\n")
        f.write('{"event": "round", "se')
    assert [e["seq"] for e in sinks.read_jsonl(path)] == [0, 1]


def test_terminal_sink_prints_what_the_reference_prints(capsys):
    events = _events() + [
        {"event": "host_death", "proc": 0, "round": 2, "dead_hosts": [1]},
        {"event": "elastic_reassign", "proc": 0, "old_shards": 4,
         "new_shards": 2, "moved": {"2": 1}}]
    sinks.write_events(events, sinks.TerminalSink())
    out = capsys.readouterr().out
    sinks.write_events(events, jsinks.TerminalSink())
    assert out == capsys.readouterr().out
    assert "round 0" in out and "host death" in out and "replan" in out


# ---------------------------------------------------------------------------
# the Telemetry facade and disabled mode
# ---------------------------------------------------------------------------
def test_disabled_telemetry_creates_no_files(tmp_path):
    tel = obs.maybe(None)
    assert tel is obs.DISABLED and not tel.enabled
    assert tel.emit("round", x=1) is None
    assert tel.emit_round({"round": 0}) is None
    with tel.span("phase") as sp:
        assert sp.fence(5) == 5
    assert tel.phase_seconds() == {} and tel.merge() is None
    tel.close()
    assert os.listdir(tmp_path) == []


def test_telemetry_emit_wraps_envelope(tmp_path, monkeypatch):
    tel = obs.Telemetry.create(str(tmp_path), process_id=7)
    r1 = tel.emit("run_start", path="loop")
    r2 = tel.emit("run_end", rounds=3)
    tel.close()
    assert (r1["proc"], r1["seq"]) == (7, 0)
    assert (r2["proc"], r2["seq"]) == (7, 1)
    assert r2["t"] >= r1["t"]
    assert list(r1)[:4] == list(jmetrics.ENVELOPE_FIELDS)
    events = sinks.read_jsonl(sinks.proc_path(str(tmp_path), 7))
    assert [e["event"] for e in events] == ["run_start", "run_end"]
    # the process id: 0 without a process group, else the group rank
    assert obs.Telemetry.create(str(tmp_path / "a")).process_id == 0
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    tel = obs.Telemetry.create(str(tmp_path / "b"))
    tel.close()
    assert tel.process_id == 3
    assert os.listdir(tmp_path / "b") == ["telemetry-p3.jsonl"]


# ---------------------------------------------------------------------------
# the loop driver's telemetry
# ---------------------------------------------------------------------------
def _build_trainer(**kw):
    env_mod, cfg = registry.make("traffic", horizon=16)
    info = cfg.info()
    pc = policy_mod.PolicyConfig(obs_dim=info.obs_dim,
                                 n_actions=info.n_actions, hidden=(16,))
    ac = influence.AIPConfig(in_dim=info.alsh_dim,
                             n_sources=info.n_influence, kind="fnn",
                             hidden=(16,), epochs=2, batch=16)
    kw.setdefault("outer_rounds", 2)
    dcfg = dials.DIALSConfig(aip_refresh=2, collect_envs=2, collect_steps=16,
                             n_envs=2, rollout_steps=8, eval_episodes=2,
                             **kw)
    return dials.DIALSTrainer(env_mod, cfg, pc, ac,
                              ppo_mod.PPOConfig(epochs=1, minibatches=2),
                              dcfg, device="cpu")


def test_loop_driver_emits_schema_clean_rounds(tmp_path):
    tel_dir = str(tmp_path / "tel")
    _, h_off = _build_trainer().run(R.key(0))
    _, h_on = _build_trainer(telemetry_dir=tel_dir).run(R.key(0))
    for rec in h_off + h_on:
        assert metrics.validate_round(rec) == []
        # the port measures its phases with telemetry off too
        assert all(rec[k] > 0 for k in ("collect_s", "aip_s", "inner_s",
                                         "eval_s", "env_steps_per_s"))
        assert rec["mirror_s"] is None
    for k in ("gs_return", "aip_ce_after", "ials_reward"):
        assert [r[k] for r in h_on] == [r[k] for r in h_off], k
    events = sinks.read_jsonl(sinks.proc_path(tel_dir, 0))
    kinds = [e["event"] for e in events]
    assert kinds == ["run_start", "round", "round", "run_end"]
    assert events[0]["start_round"] == 0 and events[-1]["rounds"] == 2
    rounds = [e for e in events if e["event"] == "round"]
    assert [{k: e[k] for k in metrics.ROUND_KEYS} for e in rounds] == h_on
    assert telemetry_report.check(events) == []
    assert telemetry_report.main([tel_dir, "--check"]) == 0


def test_async_loop_driver_emits_obtain_events(tmp_path):
    tel_dir = str(tmp_path / "tel")
    _, hist = _build_trainer(async_collect=True, outer_rounds=3,
                             telemetry_dir=tel_dir).run(R.key(0))
    events = sinks.read_jsonl(sinks.proc_path(tel_dir, 0))
    obtains = [e for e in events if e["event"] == "collect_obtain"]
    assert [e["data_round"] for e in obtains] == [0, 0, 1]
    assert [e["forced"] for e in obtains] == [True, False, False]
    assert all(e["mode"] == "thread" and e["wait_s"] >= 0 for e in obtains)
    assert events[0]["async_collect"] is True
    assert [e["data_round"] for e in events if e["event"] == "round"] == \
        [r["data_round"] for r in hist]
    assert all(r["env_steps_per_s"] is None for r in hist)
    assert telemetry_report.main([tel_dir, "--check"]) == 0
