"""The port's tooling on the CPU, held against the JAX package's: grid
sweeps (``utils/sweep.py``), ``cli inspect``, ``data/repack.py``,
``utils/viz.py`` and ``data/playback.py`` (copies of the reference's
jax-free modules), each called with the same inputs on both sides and
compared answer for answer, file for file. Render tests carry the
reference's EGL ``skipif``. Torch runs on one intra-op thread.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import rgb_proprioceptive_pose_estimator_tpu as rppe
from rgb_proprioceptive_pose_estimator_tpu import cli as jax_cli
from rgb_proprioceptive_pose_estimator_tpu.data import playback as jax_playback
from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu.data.repack import (
    repack_file as jax_repack_file,
)
from rgb_proprioceptive_pose_estimator_tpu.utils import viz as jax_viz
from rgb_proprioceptive_pose_estimator_tpu.utils.sweep import (
    parse_grid as jax_parse_grid,
)
from rgb_proprioceptive_pose_estimator_tpu.utils.sweep import (
    run_sweep as jax_run_sweep,
)
import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch import cli
from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data import playback
from rgb_proprioceptive_pose_estimator_tpu_torch.data.repack import (
    repack_file,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import viz
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.sweep import (
    parse_grid,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 (the outcome is compared)
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "train.lr=1e-3|3e-4; model.proprio_dropout=0|0.5",
    "data.crop_scale=0.8,1.0|0.5,1.0",
    "model.cameras=agentview|robot0_eye_in_hand; train.seed=1|2|3",
    "train.lr", "train.lr=1|2; train.lr=3", "  ;  ", "train.lr=",
    "train.lr=1e-3|"])
def test_parse_grid_as_the_reference(spec):
    assert _outcome(parse_grid, spec) == _outcome(jax_parse_grid, spec)


def _sweep_cfgs(tmp_path):
    over = {"train.steps": 6, "train.eval_every": 6, "train.eval_steps": 2,
            "train.ckpt_every": 6, "train.log_every": 3,
            "data.synthetic_size": 96, "data.batch_size": 16,
            "data.val_fraction": 0.25, "data.num_workers": 1,
            "dist.num_devices": 1}
    jcfg = rppe.preset("pr1").override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


def test_run_sweep_as_the_reference(tmp_path):
    """The same grid in both packages: the same run ids (directories keyed
    by the combination), rows, best run (lr 1e-7 barely moves the
    weights), and the same resumption: a second call trains nothing, a
    reordered grid nothing, a wider one only its new combination."""
    jcfg, cfg = _sweep_cfgs(tmp_path)
    grids = ["train.lr=1e-2|1e-7", "train.lr=1e-2|1e-7",
             "train.lr=1e-7|1e-2", "train.lr=1e-2|1e-7|3e-3"]
    runs = {}
    for side, fn, c in (("jax", jax_run_sweep, jcfg),
                        ("port", rppt.run_sweep, cfg)):
        out = str(tmp_path / side)
        kw = {"device": "cpu"} if side == "port" else {}
        runs[side] = [fn(c, g, out, **kw) for g in grids]
    for want, got in zip(runs["jax"], runs["port"]):
        for k in ("grid_size", "completed", "cached", "metric"):
            assert got[k] == want[k], k
        assert got["best"]["run"] == want["best"]["run"]
        assert got["best"]["overrides"] == want["best"]["overrides"]
        assert (os.path.basename(got["best"]["ckpt_dir"])
                == os.path.basename(want["best"]["ckpt_dir"]))

    def rows(side):
        with open(tmp_path / side / "sweep.jsonl") as f:
            return [json.loads(line) for line in f]

    want, got = rows("jax"), rows("port")
    assert [(r["run"], r["overrides"], os.path.basename(r["ckpt_dir"]))
            for r in got] == [(r["run"], r["overrides"],
                               os.path.basename(r["ckpt_dir"]))
                              for r in want]
    assert all(set(g) == set(w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="ckpt_dir cannot be swept"):
        rppt.run_sweep(cfg, "train.ckpt_dir=a|b", str(tmp_path / "x"))


@pytest.fixture(scope="module")
def demo_h5(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tooling") / "demo.hdf5")
    write_demo_fixture(path, n_demos=3, steps=8, image_hw=48,
                       cameras=("agentview", "robot0_eye_in_hand"),
                       filter_keys={"valid": [0, 2]})
    return path


def _cfgs(path, preset="pr2", **overrides):
    jcfg = rppe.preset(preset).override(**{"data.path": path, **overrides})
    return jcfg, Config.from_dict(jcfg.to_dict())


def test_inspect_reports_as_the_reference(demo_h5, tmp_path):
    """inspect_dataset on the demo fixture and on a states-only file (the
    MJCF's bodies, sites and cameras listed), and the CLI around it."""
    states = jax_playback.write_states_fixture(str(tmp_path / "s.hdf5"),
                                               n_demos=2, steps=9)
    for path in (demo_h5, f"{demo_h5},{states}"):
        jcfg, cfg = _cfgs(path)
        assert cli.inspect_dataset(cfg) == jax_cli.inspect_dataset(jcfg)
    jcfg, cfg = _cfgs(states)
    report = cli.inspect_dataset(cfg)
    assert report["files"][0]["target_body_candidates (free bodies)"] == [
        "cube"]
    _, nohdf5 = _cfgs("", preset="pr1")
    with pytest.raises(SystemExit, match="hdf5 data source"):
        cli.inspect_dataset(nohdf5)


def _tree(path):
    """Every dataset (bytes) and attribute of an hdf5 file, by name."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(v).tobytes()
                     for k, v in sorted(obj.attrs.items())}
            if isinstance(obj, h5py.Dataset):
                data = obj[...]
                if data.dtype == object:
                    data = b"".join(np.asarray(x).tobytes() for x in data)
                else:
                    data = (str(data.dtype), data.shape, data.tobytes())
                out[name] = (data, attrs)
            else:
                out[name] = attrs
        f.visititems(visit)
        out["/"] = {k: np.asarray(v).tobytes()
                    for k, v in sorted(f.attrs.items())}
    return out


@pytest.mark.parametrize("encode,size", [("raw", 32), ("jpeg", 24),
                                         ("png", 48)])
def test_repack_file_writes_the_references_datasets(demo_h5, tmp_path,
                                                    encode, size):
    kw = dict(cameras=("agentview",), size=size, encode=encode,
              max_demos=2)
    want = jax_repack_file(demo_h5, str(tmp_path / "jax.hdf5"), **kw)
    got = repack_file(demo_h5, str(tmp_path / "port.hdf5"), **kw)
    assert {k: got[k] for k in ("demos", "frames", "bytes_in")} == {
        k: want[k] for k in ("demos", "frames", "bytes_in")}
    assert _tree(str(tmp_path / "port.hdf5")) == _tree(
        str(tmp_path / "jax.hdf5"))


def test_cli_repack_curves_and_inspect_sample_as_the_reference(
        demo_h5, tmp_path, capsys):
    """The CLI's repack, curves and inspect --sample: the JAX package's
    output with the other package's paths."""
    metrics = tmp_path / "metrics.jsonl"
    with open(metrics, "w") as f:
        for step in (1, 2, 3, 4):
            f.write(json.dumps({"step": step, "train/loss": 1.0 / step,
                                "train/lr": 1e-3}) + "\n")
        f.write(json.dumps({"step": 4, "eval/loss": 0.3,
                            "eval/pos_mae_cm": 2.0}) + "\n")
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        runs = [
            ["repack", "--preset", "pr2", "--src", demo_h5, "--size", "32",
             "--out", str(d / "r.hdf5")],
            ["curves", "--metrics", str(metrics), "--out",
             str(d / "c.png")],
            ["inspect", "--preset", "pr2", "--set", f"data.path={demo_h5}",
             "--sample", str(d / "s.png")],
        ]
        outs[side] = []
        for argv in runs:
            assert main(argv) == 0
            text = capsys.readouterr().out.replace(str(d), "<out>")
            outs[side].append(json.loads(text))
    assert outs["port"] == outs["jax"]
    assert _tree(str(tmp_path / "port" / "r.hdf5")) == _tree(
        str(tmp_path / "jax" / "r.hdf5"))


def test_viz_returns_the_references_reports(demo_h5, tmp_path):
    rs = np.random.RandomState(0)
    pred, target = rs.randn(12, 3), rs.randn(12, 3)
    pe, re_ = rs.rand(12), rs.rand(12) * 10
    for side, mod in (("jax", jax_viz), ("port", viz)):
        path = str(tmp_path / f"{side}.png")
        assert mod.plot_trajectory(pred, target, pe, re_, path,
                                   title="t") == path
        with open(path, "rb") as f:
            assert f.read(4) == b"\x89PNG"
    jcfg, cfg = _cfgs(demo_h5)
    want = jax_viz.save_sample_grid(jcfg, str(tmp_path / "g.png"))
    assert viz.save_sample_grid(cfg, str(tmp_path / "g.png")) == want
    metrics = str(tmp_path / "m.jsonl")
    with open(metrics, "w") as f:
        for step in range(1, 6):
            f.write(json.dumps({"step": step, "train/loss": 1.0 / step,
                                "eval/rot_mae_deg": 5.0 / step}) + "\n")
    assert viz.plot_metrics(metrics, str(tmp_path / "m.png")) == \
        jax_viz.plot_metrics(metrics, str(tmp_path / "m.png"))
    with pytest.raises(ValueError):
        viz.save_sample_grid(_cfgs("", preset="pr1")[1],
                             str(tmp_path / "x.png"))


@pytest.mark.parametrize("width", ["raw", "time_prefixed", "extra",
                                   "narrow"])
def test_split_state_as_the_reference(width):
    nq, nv = 9, 8
    w = {"raw": nq + nv, "time_prefixed": 1 + nq + nv,
         "extra": 1 + nq + nv + 3, "narrow": nq + nv - 1}[width]
    state = np.arange(w, dtype=np.float64) * 0.5
    got = _outcome(playback.split_state, state, nq, nv)
    want = _outcome(jax_playback.split_state, state, nq, nv)
    if got[0] == "ok":
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    else:
        assert got == want


def test_write_states_fixture_as_the_reference(tmp_path):
    for seed in (0, 3):
        a = playback.write_states_fixture(str(tmp_path / f"p{seed}.hdf5"),
                                          n_demos=2, steps=7, seed=seed)
        b = jax_playback.write_states_fixture(
            str(tmp_path / f"j{seed}.hdf5"), n_demos=2, steps=7, seed=seed)
        assert _tree(a) == _tree(b)


def _egl_available() -> bool:
    """The reference's probe, in a child as the converter renders, here
    through the port's copy (its child imports no torch)."""
    code = ("import sys\n"
            "from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback "
            "import _import_mujoco\n"
            "mujoco = _import_mujoco()\n"
            "m = mujoco.MjModel.from_xml_string(\"<mujoco><worldbody>"
            "<geom type='sphere' size='.1'/></worldbody></mujoco>\")\n"
            "mujoco.Renderer(m, 16, 16).close()\n"
            "assert 'torch' not in sys.modules\n")
    env = dict(os.environ, _RPPE_RENDER_WORKER="1", PYTHONPATH=ROOT)
    try:
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, env=env,
                              timeout=180).returncode == 0
    except Exception:  # noqa: BLE001 (no GL: the render tests skip)
        return False


needs_egl = pytest.mark.skipif(
    not _egl_available(), reason="no headless MuJoCo GL (EGL) available")


@needs_egl
def test_render_writes_the_references_dataset(tmp_path, capsys):
    """cli render of a states fixture: the reference's summary and file,
    rendered in the isolated child."""
    src = jax_playback.write_states_fixture(str(tmp_path / "s.hdf5"),
                                            n_demos=2, steps=6)
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = str(tmp_path / f"{side}.hdf5")
        assert main(["render", "--preset", "pr2", "--src", src, "--set",
                     "model.image_size=32", "--out", out]) == 0
        outs[side] = json.loads(capsys.readouterr().out.replace(out, "<o>"))
    assert outs["port"] == outs["jax"]
    assert _tree(str(tmp_path / "port.hdf5")) == _tree(
        str(tmp_path / "jax.hdf5"))
