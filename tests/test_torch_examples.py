"""The port's examples (``examples/torch/``), the counterparts of
``examples/*.py``, run end to end on the CPU (``--device cpu``) with the
step counts of tests/test_examples.py, so that they cannot rot as the
API evolves; the two playback examples skip without headless GL, as the
reference's do. Each imports the port and nothing of JAX, and runs on
CUDA unless told otherwise. Torch runs on one intra-op thread."""

import ast
import os
import runpy
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
NAMES = ["end_to_end.py", "finetune_and_serve.py", "robomimic_workflow.py",
         "states_playback_workflow.py", "predictive_pose.py"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(name: str, *argv: str) -> None:
    old = sys.argv
    sys.argv = [name, *argv, "--device", "cpu"]
    try:
        runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    finally:
        sys.argv = old


def _egl_available() -> bool:
    """The reference's probe, in a child as the converter renders, through
    the port's copy (its child imports no torch)."""
    code = ("from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback "
            "import _import_mujoco\n"
            "mujoco = _import_mujoco()\n"
            "m = mujoco.MjModel.from_xml_string(\"<mujoco><worldbody>"
            "<geom type='sphere' size='.1'/></worldbody></mujoco>\")\n"
            "mujoco.Renderer(m, 16, 16).close()\n")
    env = dict(os.environ, _RPPE_RENDER_WORKER="1", PYTHONPATH=ROOT)
    try:
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, env=env,
                              timeout=180).returncode == 0
    except Exception:  # noqa: BLE001 (no GL: the playback examples skip)
        return False


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port_and_defaults_to_cuda(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        tree = ast.parse(f.read())
    assert os.path.exists(os.path.join(ROOT, "examples", name))
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert any(m.startswith("rgb_proprioceptive_pose_estimator_tpu_torch")
               for m in imported), imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "flax",
                 "optax", "rgb_proprioceptive_pose_estimator_tpu"))
    assert not bad, bad
    devices = [kw.value.value for node in ast.walk(tree)
               if isinstance(node, ast.Call) and node.args
               and isinstance(node.args[0], ast.Constant)
               and node.args[0].value == "--device"
               for kw in node.keywords if kw.arg == "default"]
    assert devices == ["cuda"]


@pytest.mark.parametrize("name,args", [
    ("end_to_end.py", ("--steps", "30")),
    ("finetune_and_serve.py", ("--steps", "30")),
    ("robomimic_workflow.py", ("--steps", "30")),
])
def test_example_runs(name, args):
    _run(name, *args)


def test_states_playback_example_runs():
    if not _egl_available():
        pytest.skip("no headless MuJoCo GL (EGL) available")
    _run("states_playback_workflow.py", "--steps", "30")


def test_predictive_pose_example_runs():
    """The pr5la predictive-pose run (tiny scale): flagship scene ->
    render -> train with target_lookahead=6 -> eval."""
    if not _egl_available():
        pytest.skip("no headless MuJoCo GL (EGL) available")
    _run("predictive_pose.py", "--demos", "3", "--demo-steps", "12",
         "--steps", "8", "--batch", "4", "--image-hw", "32")
