"""The port's spans (utils/prof.py): nesting, step ids, the off path, the
CPU's device time, the recorder's bound, and the trace window's spans
file in a fit. Spans record while a profiler trace runs."""

import json
import threading

import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch import api
from rgb_proprioceptive_pose_estimator_tpu_torch.config import preset
from rgb_proprioceptive_pose_estimator_tpu_torch.engine import train_step as ts
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import prof

SPANS = {"rppe.step", "rppe.step.prepare", "rppe.step.forward",
         "rppe.step.backward", "rppe.step.optimizer", "rppe.feed",
         "rppe.feed.wait", "rppe.feed.h2d"}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def recording():
    prof.drain()
    with _profiler():
        yield
    prof.drain()


def test_spans_nest_with_their_parents_and_step_ids(recording):
    with prof.span("feed") as feed:
        feed.count("ready", 2)
        with prof.span("feed.wait"):
            pass
    with prof.span("step", step=7):
        with prof.span("step.a"):
            with prof.span("step.a.inner"):
                pass
        with prof.span("step.b"):
            pass
    with prof.span("outer"):
        with prof.span("step", step=8):
            pass
    with prof.span("after"):
        pass
    records = prof.drain()
    got = [(r["name"], r["parent"], r["step"]) for r in records]
    assert got == [("feed", None, 7), ("feed.wait", 0, 7),
                   ("step", None, 7), ("step.a", 2, 7),
                   ("step.a.inner", 3, 7), ("step.b", 2, 7),
                   # a span around a step is not that step's
                   ("outer", None, None), ("step", 6, 8),
                   # nothing follows: no step
                   ("after", None, None)]
    assert [r["id"] for r in records] == list(range(len(records)))
    assert records[0]["counters"] == {"ready": 2.0}
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        assert r["host_ms"] == pytest.approx(
            (r["end_ns"] - r["start_ns"]) * 1e-6)
        assert r["device_ms"] is None
    inner, outer = records[4], records[3]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]
    assert prof.drain() == []


def test_recording_off_returns_the_shared_no_op(monkeypatch):
    prof.drain()
    assert not torch.autograd._profiler_enabled()

    def refuse(*args, **kwargs):
        raise AssertionError("the off path read a clock or recorded")

    monkeypatch.setattr(prof.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a = prof.span("rppe.step", device="cpu", step=0)
    b = prof.span("rppe.feed")
    assert a is b is prof.NULL_SPAN and not a.active
    with a as sp:
        sp.count("ready", 3)
    # a whole train step (its five spans) with recording off
    cfg = preset("pr1").override(**{"data.batch_size": 4})
    state = create_state(cfg, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    batch = {"proprio": torch.randn(4, cfg.model.proprio_dim, generator=g),
             "target_pos": torch.rand(4, 3, generator=g),
             "target_quat": torch.nn.functional.normalize(
                 torch.randn(4, 4, generator=g), dim=-1)}
    ts.train_step(state, batch, cfg.train)
    monkeypatch.undo()
    assert prof.drain() == []


def test_cpu_device_time_is_the_host_duration(recording):
    with prof.span("on the cpu", device=torch.device("cpu")):
        torch.ones(64, 64).sum()
    with prof.span("no device"):
        pass
    on_cpu, none = prof.drain()
    assert on_cpu["device_ms"] == on_cpu["host_ms"] > 0
    assert none["device_ms"] is None


def test_spans_record_under_a_profiler_trace():
    prof.drain()
    with _profiler() as p:
        with prof.span("rppe.traced", device="cpu", step=0):
            torch.ones(8).sum()
        # another thread runs no trace: no span there
        other = []
        worker = threading.Thread(
            target=lambda: other.append(prof.span("rppe.worker")))
        worker.start()
        worker.join()
    assert other == [prof.NULL_SPAN]
    assert prof.span("rppe.after") is prof.NULL_SPAN
    (record,) = prof.drain()
    assert record["name"] == "rppe.traced"
    # the span's record_function range is in the profiler's trace
    assert any(e.name == "rppe.traced" for e in p.events())


def test_a_long_trace_keeps_the_newest_spans(monkeypatch, recording):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    with prof.span("outer", step=0):
        for i in range(5):
            with prof.span(f"inner{i}"):
                pass
    records = prof.drain()
    assert [r["name"] for r in records] == ["inner2", "inner3", "inner4"]
    # their parent fell out: none to name
    assert [r["parent"] for r in records] == [None, None, None]
    assert [r["step"] for r in records] == [0, 0, 0]


def test_summary_per_call_and_per_step():
    def rec(name, step, host, device=None, **counters):
        return {"name": name, "step": step, "host_ms": host,
                "device_ms": device, "counters": counters}

    records = [rec("rppe.feed.wait", 4, 1.0, ready=2),
               rec("rppe.feed.wait", 4, 2.0, ready=1),
               rec("rppe.step", 4, 10.0, 9.0), rec("rppe.feed.wait", 5, 3.0),
               rec("rppe.step", 5, 12.0, 11.0),
               # after the last step: not one of them
               rec("rppe.feed.wait", None, 50.0)]
    assert prof.summary(records) == {
        "rppe.feed.wait.calls": 4.0, "rppe.feed.wait.host_ms": 14.0,
        "rppe.feed.wait.ready": 0.75,
        "rppe.step.calls": 2.0, "rppe.step.host_ms": 11.0,
        "rppe.step.device_ms": 10.0}
    assert prof.summary(records, per_step=True) == {
        "rppe.feed.wait.calls": 1.5, "rppe.feed.wait.host_ms": 3.0,
        "rppe.feed.wait.ready": 1.5,
        "rppe.step.calls": 1.0, "rppe.step.host_ms": 11.0,
        "rppe.step.device_ms": 10.0}
    assert prof.summary(records[:2], per_step=True) == {}


def test_fit_writes_the_spans_file_and_logs_their_means(tmp_path):
    prof.drain()
    # an earlier trace's spans, which the window leaves out
    with _profiler():
        with prof.span("rppe.step", step=0):
            with prof.span("rppe.step.forward"):
                pass
    cfg = preset("pr1").override(**{
        "data.synthetic_size": 64, "data.batch_size": 8,
        "data.num_workers": 2, "train.steps": 6, "train.log_every": 1,
        "train.eval_every": 0, "train.ckpt_every": 0,
        "train.ckpt_dir": str(tmp_path / "run"),
        "train.profile_dir": str(tmp_path / "trace"),
        "train.profile_start": 2, "train.profile_steps": 3})
    api.train(cfg, device="cpu")
    with open(tmp_path / "trace" / "spans_rank0.json") as f:
        spans = json.load(f)
    assert spans["rank"] == 0
    records = spans["spans"]
    assert {r["name"] for r in records} == SPANS
    steps = [r["step"] for r in records if r["name"] == "rppe.step"]
    # the window opens after step 2 (0-based step ids 2, 3, 4 follow)
    assert steps == [2, 3, 4]
    for r in records:
        assert r["step"] in steps, r
        if r["name"].startswith("rppe.step"):
            assert r["device_ms"] == r["host_ms"]
        else:
            assert r["device_ms"] is None
    feeds = [r for r in records if r["name"] == "rppe.feed"]
    assert len(feeds) == 3 and all("ready" in r["counters"] for r in feeds)
    assert (tmp_path / "trace" / "trace_rank0.json").exists()
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    (trace,) = [line for line in lines
                if any(k.startswith("trace/") for k in line)]
    assert trace["step"] == 5
    for name in SPANS:
        assert trace[f"trace/{name}.calls"] >= 3
        assert trace[f"trace/{name}.host_ms"] >= 0
    assert trace["trace/rppe.step.calls"] == 3
    assert trace["trace/rppe.step.forward.device_ms"] > 0
    assert "trace/rppe.feed.ready" in trace
    assert "trace/rppe.feed.device_ms" not in trace
    assert prof.drain() == []
