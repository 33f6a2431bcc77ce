"""run.py end to end: no result without a card, and a tiny cell on the
CPU through the same path as a card's run, with the plain kernels."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from bench_cuda.lib import cells, manifest
from bench_cuda.tests.tiny import CELL, ROOT, make_root

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench_cuda/run.py", "--workload",
         "pr5-train-pallas", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_cuda", tmp_path / "bench_cuda",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "bench_cuda/run.py", "--workload",
         "pr5-train-pallas", "--seed", "3", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_prints_a_well_formed_line(tmp_path, capsys, trace):
    root = make_root(tmp_path)
    result = cells.run(manifest.Manifest(root), CELL, 2 ** 31 + 11, 1.0,
                       trace, "cpu", time.time())
    cells.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = manifest.Manifest(root)
    if trace:
        # no device trace on the CPU: only the host's readings
        assert set(line["metrics"]) == {"data_wait_ms", "train_mfu"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in
                                        bench.end_to_end(CELL)}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    checks = err.strip().splitlines()[-len(line["checks"]):]
    assert [c.split(":")[0] for c in checks] == [
        f"check {k}" for k in line["checks"]]


def test_idle_share_leaves_out_the_tracer():
    # 8 traced steps busy 0.34 s each; the untraced window's step 0.341 s
    read = manifest.reader("device_idle_share")
    ctx = {"trace": {"busy_s": 8 * 0.340, "window_s": 8 * 0.346,
                     "steps": 8}, "step_s": 0.341}
    assert read(ctx) == pytest.approx(1 - 0.340 / 0.341)
    assert read({"trace": {}, "step_s": 0.341}) is None
