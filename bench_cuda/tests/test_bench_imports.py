"""What the benchmark and its reference load, compared by whole
top-level module names: the port's name begins with the JAX
package's."""

from __future__ import annotations

import json
import subprocess
import sys

from bench_cuda.tests.tiny import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "rgb_proprioceptive_pose_estimator_tpu"}
PORT = "rgb_proprioceptive_pose_estimator_tpu_torch"


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
         "import json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    loaded = _top_level_after(
        "import bench_cuda.reference.pose_train, bench_cuda.counts."
        "model_counts")
    assert not loaded & JAX_SIDE
    assert PORT not in loaded


def test_the_harness_loads_the_port_and_not_jax():
    loaded = _top_level_after(
        "import runpy; runpy.run_path('bench_cuda/run.py'); "
        "import bench_cuda.lib.cells, bench_cuda.control")
    assert PORT in loaded
    assert not loaded & JAX_SIDE


def test_whole_name_comparison():
    sys.path.insert(0, str(ROOT / "bench_cuda"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "bench_cuda"))
    saved = dict(sys.modules)
    try:
        sys.modules[PORT + "_fake.x"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & JAX_SIDE)
        sys.modules["jaxlib.fake"] = sys
        assert "jaxlib" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
