"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name."""

from __future__ import annotations

import json
import re

import pytest

from bench_cuda.lib import manifest
from bench_cuda.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_cuda"]
    assert len(BENCH["command"]) <= 32
    assert all(_text_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    for e in BENCH[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert KEYS[key] <= set(e) <= KEYS[key] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert _text_ok(e[text]), (e["name"], text)


def test_cells_and_bounds():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = BENCH["workloads"]
    assert {c["config"] for c in cells} == configs
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert all(c["chips"] in (1, 4) for c in cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {c["name"] for c in cells}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"trainer", "step", "model and encoder",
                      "kernels", "device"}


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    bench = manifest.Manifest(ROOT)
    spec = bench.workload(cell)
    config = bench.config(spec["config"])
    assert spec["limits"] and set(spec["limits"]) <= {
        "loss_gap", "grad_gap", "grad_gap_median", "change_gap",
        "change_gap_median", "change_dir_gap", "change_dir_gap_median"}
    assert config["reduced"] == next(
        c["reduced"] for c in BENCH["configs"] if c["name"] == spec["config"])
    assert bench.end_to_end(cell) and bench.per_layer(cell)
    for key in config["reduced"]:
        assert NAME.match(key)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_found_by_name(metric):
    assert callable(manifest.reader(metric))


def test_config_files_keep_published_widths():
    for c in BENCH["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        mine = spec["config"]
        source = json.loads((ROOT / "cfg" / f"{spec['preset']}.json")
                            .read_text())
        for group in ("model", "data", "train", "dist"):
            for k, v in source[group].items():
                if f"{group}.{k}" not in c["reduced"]:
                    assert mine[group][k] == v, f"{group}.{k}"
