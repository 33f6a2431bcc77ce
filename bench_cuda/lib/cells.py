"""A run of one cell: its ranks, the result's metrics and the line that
reports them."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from bench_cuda.lib import data as bench_data
from bench_cuda.lib import manifest as bench_manifest
from bench_cuda.lib import train_cell


def _devices(device: str, chips: int) -> List[torch.device]:
    if device == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _mean_trace(traces: List[Dict]) -> Dict:
    traces = [t for t in traces if t]
    if not traces:
        return {}
    groups: Dict[str, float] = {}
    for t in traces:
        for g, v in t["groups"].items():
            groups[g] = groups.get(g, 0.0) + v / len(traces)
    return {"busy_s": float(np.mean([t["busy_s"] for t in traces])),
            "window_s": float(np.mean([t["window_s"] for t in traces])),
            "steps": traces[0]["steps"], "groups": groups,
            "device_ops": traces[0]["device_ops"],
            "idle_gaps": traces[0]["idle_gaps"]}


def run(bench: bench_manifest.Manifest, name: str, seed: int,
        seconds: float, trace: bool, device: str, start: float,
        rank_fn=train_cell.run_rank) -> Dict:
    """Run cell ``name`` once, each rank in ``rank_fn``; returns what
    ``report`` prints."""
    workload = bench.workload(name)
    config = bench.config(workload["config"])
    cfg = train_cell.cell_config(config, workload, bench_data.Seeds(seed))
    chips = workload["chips"]
    devices = _devices(device, chips)
    if chips == 1:
        outs = [rank_fn(cfg, devices[0], workload, seed, seconds, trace)]
    else:
        from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

        backend = "gloo" if device == "cpu" else "nccl"
        outs = dist.launch(rank_fn, cfg, devices, backend, workload, seed,
                           seconds, trace)
    first = outs[0]
    timed = first["timed"]
    batch = cfg.data.batch_size
    samples_per_s = timed["steps"] * batch / timed["window_s"]
    model = cfg.to_dict()["model"]
    values = {
        "setup_s": timed["start_wall"] - start,
        "train_samples_per_s": samples_per_s,
        "train_step_p90_ms": float(np.percentile(timed["step_ms"], 90)),
    }
    peak = max(o["timed"]["peak_bytes"] for o in outs)
    failed = max(o["timed"]["failed"] for o in outs)
    metrics = {}
    if not trace:
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    tr = _mean_trace([o.get("trace", {}) for o in outs]) if trace else {}
    if trace:
        ctx = {"trace": tr, "chips": chips, "model": model,
               "rows_per_rank": batch // chips,
               "samples_per_s": samples_per_s,
               "step_s": timed["window_s"] / timed["steps"],
               "data_wait_ms": timed["data_wait_s"] / timed["steps"] * 1e3,
               "peak_bytes": peak}
        for m in bench.per_layer(name):
            v = bench_manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if device == "cuda" else "none"}
    if trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
    limits = workload["limits"]
    numbers = first["numbers"]
    checks = {k: {"value": numbers[k], "limit": limits[k],
                  "at": first["where"][k]} for k in limits}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    out = {"correct": correct, "attempted": timed["steps"], "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and tr:
        out["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                            "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    out["checks"] = checks
    return out


def report(result: Dict) -> None:
    """Each number compared beside its limit as the last lines of
    standard error, then the result as the last line of standard
    output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"(worst at {c['at']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
