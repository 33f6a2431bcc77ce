"""A tiny copy of a cell for the benchmark's CPU tests: the pr5-pallas
configuration's widths at 32 px, 4 demos of 10 steps, batch 8."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "pr5-tiny"
# the tiny cell's own limits, above its sound runs' readings and below
# its control's (see PERF.md); the real cells' limits are in their files
TINY_LIMITS = {"change_gap": 0.03, "change_gap_median": 0.001,
               "change_dir_gap_median": 0.4}


def make_root(tmp: Path, chips: int = 1, extra=None) -> Path:
    """A directory holding a BENCHMARK.json with one tiny cell, its
    configuration and its cell file; returns it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads(
        (ROOT / "bench_cuda/configs/pr5-pallas.json").read_text())
    config["config"]["model"]["image_size"] = 32
    config["config"]["data"]["batch_size"] = 8
    config["config"]["data"]["num_workers"] = 2
    workload = json.loads(
        (ROOT / "bench_cuda/workloads/pr5-train-pallas.json").read_text())
    workload.update(chips=chips, demos=4, steps_per_demo=10, trace_steps=2)
    workload["limits"] = TINY_LIMITS
    workload.update(extra or {})
    bench["configs"].append({**bench["configs"][0], "name": "tiny",
                             "file": "bench_cuda/configs/tiny.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tiny", "chips": chips,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(CELL)
    workload["config"] = "tiny"
    (tmp / "bench_cuda/configs").mkdir(parents=True)
    (tmp / "bench_cuda/workloads").mkdir(parents=True)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "bench_cuda/configs/tiny.json").write_text(json.dumps(config))
    (tmp / f"bench_cuda/workloads/{CELL}.json").write_text(
        json.dumps(workload))
    return tmp

