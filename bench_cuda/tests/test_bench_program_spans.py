"""The five readers of the program's own spans (``lib/program_spans``), and
the trace's reduction and the seven earlier readers pinned on a fixed
synthetic trace."""

from __future__ import annotations

import json
import time

import pytest

from bench_cuda.lib import cells, manifest
from bench_cuda.lib import trace as bench_trace
from bench_cuda.tests.tiny import CELL, ROOT, make_root
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import prof

PROGRAM = {"device_aug_ms": "rppe.step.prepare",
           "forward_ms": "rppe.step.forward",
           "backward_ms": "rppe.step.backward",
           "optimizer_ms": "rppe.step.optimizer",
           "feed_blocked_ms": "rppe.feed.wait"}
EARLIER = ["data_wait_ms", "train_mfu", "elementwise_ms", "conv_ms",
           "channel_stats_roofline", "device_idle_share", "peak_mem_gib"]


def _stand_in_trace(monkeypatch):
    """A device trace in place of the card's, which a CPU run lacks."""
    def mean_trace(traces):
        return {"busy_s": 0.02, "window_s": 0.02, "steps": 2, "groups": {},
                "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(cells, "_mean_trace", mean_trace)


def _kept(monkeypatch):
    got = []
    summary = prof.summary

    def keep(records, per_step=False):
        got.append(summary(records, per_step=per_step))
        return got[-1]

    monkeypatch.setattr(prof, "summary", keep)
    return got


def test_a_traced_run_reads_the_programs_spans(tmp_path, monkeypatch):
    _stand_in_trace(monkeypatch)
    kept = _kept(monkeypatch)
    prof.drain()
    root = make_root(tmp_path)
    result = cells.run(manifest.Manifest(root), CELL, 2 ** 31 + 13, 1.0,
                       True, "cpu", time.time())
    assert result["correct"] is True
    metrics = result["metrics"]
    assert set(PROGRAM) <= set(metrics)
    (spans,) = kept
    # the cell's two traced steps, each span once or more a step
    assert spans["rppe.step.calls"] == 1
    for metric, name in PROGRAM.items():
        key = "host_ms" if metric == "feed_blocked_ms" else "device_ms"
        assert metrics[metric] == {"value": spans[f"{name}.{key}"],
                                   "unit": "ms"}
        assert metrics[metric]["value"] >= 0
    phases = sum(metrics[m]["value"] for m in
                 ("device_aug_ms", "forward_ms", "backward_ms",
                  "optimizer_ms"))
    assert 0 < phases <= spans["rppe.step.device_ms"]
    assert spans["rppe.feed.wait.host_ms"] <= spans["rppe.feed.host_ms"]
    # drained: nothing is left for the next run
    assert prof.drain() == []


def test_without_a_device_trace_nothing_is_read(tmp_path):
    prof.drain()
    root = make_root(tmp_path)
    result = cells.run(manifest.Manifest(root), CELL, 2 ** 31 + 17, 1.0,
                       True, "cpu", time.time())
    assert not set(PROGRAM) & set(result["metrics"])
    assert prof.drain() == []


def test_a_program_without_spans_gives_no_reading(monkeypatch):
    # a program whose utils/prof has neither spans nor drain
    monkeypatch.delattr(prof, "drain")
    ctx = {"trace": {"steps": 8, "busy_s": 1.0}}
    for metric in PROGRAM:
        assert manifest.reader(metric)(ctx) is None
    assert ctx["program"] == {}


RAW = {"steps": 2,
       "device": [
           ("void at::native::elementwise_kernel<128, 4>(int, F)",
            0.0010, 0.0040),
           ("sm90_xmma_wgrad_implicit_gemm_bf16", 0.0040, 0.0070),
           ("channel_stats_kernel", 0.0075, 0.0080),
           ("Memcpy HtoD (Pageable -> Device)", 0.0081, 0.0082),
           ("void at::native::vectorized_elementwise_kernel<4>(int)",
            0.0110, 0.0150),
           ("cutlass__5x_cudnn::Kernel<conv>", 0.0150, 0.0175),
           ("multi_tensor_apply_kernel<adam>", 0.0176, 0.0180),
           ("ncclDevKernel_AllReduce_Sum_f32", 0.0180, 0.0185)],
       "spans": [("step", 0.0, 0.0100), ("data_wait", 0.0, 0.0009),
                 ("train_step", 0.0009, 0.0100),
                 ("step", 0.0100, 0.0190), ("data_wait", 0.0100, 0.0108),
                 ("train_step", 0.0108, 0.0190)]}
GROUPS = {"other elementwise/reduction": 0.007,
          "convolution (cuDNN)": 0.0055, "channel_stats": 0.0005,
          "copies": 0.0001, "optimizer": 0.0004, "nccl": 0.0005}
OPS = [("at::native::vectorized_elementwise_kernel", 0.004),
       ("at::native::elementwise_kernel", 0.003),
       ("sm90_xmma_wgrad_implicit_gemm_bf16", 0.003),
       ("cutlass__5x_cudnn::Kernel", 0.0025),
       ("channel_stats_kernel", 0.0005),
       ("ncclDevKernel_AllReduce_Sum_f32", 0.0005),
       ("multi_tensor_apply_kernel", 0.0004), ("Memcpy HtoD", 0.0001)]
GAPS = [("train_step", 0.0028), ("data_wait", 0.001),
        ("train_step", 0.0005), ("train_step", 0.0005),
        ("train_step", 0.0001), ("train_step", 0.0001)]
# the seven earlier readers on the mean of SUMMARY and its double
READINGS = {"data_wait_ms": 3.0, "train_mfu": 6.49401619413549,
            "elementwise_ms": 5.25, "conv_ms": 4.125,
            "channel_stats_roofline": 793.2929834029844,
            "device_idle_share": -0.05, "peak_mem_gib": 32.11135005950928}


def _pairs(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-9)


def test_the_trace_and_the_earlier_readers_read_as_before():
    s = bench_trace.summarise(RAW)
    assert s["busy_s"] == pytest.approx(0.014, rel=1e-9)
    assert s["window_s"] == pytest.approx(0.019, rel=1e-9)
    assert s["steps"] == 2
    assert s["groups"] == pytest.approx(GROUPS, rel=1e-9)
    _pairs(s["device_ops"], OPS)
    _pairs(s["idle_gaps"], GAPS)
    double = dict(s, busy_s=2 * s["busy_s"], window_s=0.03,
                  groups={k: 2 * v for k, v in s["groups"].items()})
    m = cells._mean_trace([s, {}, double])
    assert m["busy_s"] == pytest.approx(0.021, rel=1e-9)
    assert m["window_s"] == pytest.approx(0.0245, rel=1e-9)
    assert m["groups"] == pytest.approx(
        {k: 1.5 * v for k, v in GROUPS.items()}, rel=1e-9)
    assert m["device_ops"] == s["device_ops"]
    assert m["idle_gaps"] == s["idle_gaps"]
    model = json.loads((ROOT / "bench_cuda/configs/pr5-pallas.json")
                       .read_text())["config"]["model"]
    ctx = {"trace": m, "chips": 1, "model": model, "rows_per_rank": 1024,
           "samples_per_s": 3000.0, "step_s": 0.01, "data_wait_ms": 3.0,
           "peak_bytes": 34479299584}
    for name in EARLIER:
        assert manifest.reader(name)(ctx) == pytest.approx(
            READINGS[name], rel=1e-9), name
