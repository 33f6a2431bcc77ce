"""``BENCHMARK.json`` and the files it names: a cell's file under
``bench_cuda/workloads/``, a configuration's under ``bench_cuda/configs/``
and a per-layer metric's reader under ``bench_cuda/metrics/``, each found
by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
METRICS_DIR = BENCH_DIR / "metrics"


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "bench_cuda"

    def _entry(self, key: str, name: str) -> Dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def workload(self, name: str) -> Dict:
        """The cell's file, checked against its BENCHMARK.json entry."""
        entry = self._entry("workloads", name)
        spec = json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())
        for key in ("config", "chips"):
            if spec[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json: {key} "
                                 f"{spec[key]!r} != BENCHMARK.json's "
                                 f"{entry[key]!r}")
        return spec

    def config(self, name: str) -> Dict:
        self._entry("configs", name)
        return json.loads((self.dir / "configs" / f"{name}.json").read_text())

    def _for(self, key: str, cell: str) -> List[Dict]:
        return [m for m in self.spec[key]
                if "workloads" not in m or cell in m["workloads"]]

    def end_to_end(self, cell: str) -> List[Dict]:
        return self._for("end_to_end", cell)

    def per_layer(self, cell: str) -> List[Dict]:
        return self._for("per_layer", cell)


def reader(name: str) -> Callable[[Dict], object]:
    """The ``read(ctx)`` of ``bench_cuda/metrics/<name>.py``."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_cuda_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
