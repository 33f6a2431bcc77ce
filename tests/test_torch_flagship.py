"""The port's MuJoCo-rendered accuracy work on the CPU
(``scripts/torch_flagship_battery.py``, ``scripts/torch_flagship_rot_diag.py``
and the ``mjrender`` row of ``scripts/torch_accuracy_artifact.py``), held
against the JAX package's scripts and against the HDF5 file route.

- ``FULL``, ``ROWS``, ``BASE`` and ``AUG_OFF`` are the reference scripts'
  dicts, and every row's configuration is the JAX package's
  ``preset("pr5").override(...)`` with the reference's own settings (read
  from its ``main`` with ``ast``), field by field;
- rendered demos travel as one ``.npz`` that numpy alone reads
  (``data/hdf5_store.save_demos_npz``/``load_demos_npz``): equal to the
  rendered HDF5 file array for array, and the lookahead relabeling on
  arrays equals the reference's ``derive_lookahead`` file, attributes
  included; ``MemoryDemoStore`` over the arrays gives the batches
  ``HDF5DemoStore`` gives over that file, bit for bit;
- a tiny end to end run: ``--render-only``, then the composition row and
  its dead-camera evals from ``--frames`` on the CPU; the rot-diag grid's
  rows over ``--frames``; the ``mjrender`` row rendered, then trained;
- without MuJoCo and without ``--frames`` each script raises naming both;
  the ``--frames`` path loads no jax, h5py or mujoco.

Renders need EGL (skipped without it, the reference's probe) and stay at
4 demos x 8 steps at 32 px. Torch runs on one intra-op thread."""

import ast
import fcntl
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.config import (
    preset as jax_preset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
    MemoryDemoStore,
    demo_file_arrays,
    load_demos_npz,
    save_demos_npz,
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    build_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--demos", "4", "--demo-steps", "8"]
TINY_RUN = TINY + ["--image-hw", "32", "--steps", "2", "--batch", "2",
                   "--device", "cpu"]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


flag = _load("torch_flagship_battery", "scripts/torch_flagship_battery.py")
diag = _load("torch_flagship_rot_diag", "scripts/torch_flagship_rot_diag.py")
acc = _load("torch_accuracy_artifact", "scripts/torch_accuracy_artifact.py")
ref_flag = _load("flagship_battery_reference", "scripts/flagship_battery.py")
ref_diag = _load("flagship_rot_diag_reference",
                 "scripts/flagship_rot_diag.py")
ref_acc = _load("accuracy_artifact_reference", "scripts/accuracy_artifact.py")
MJROW = "image+qpos (mujoco-rendered)"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _egl_available() -> bool:
    """The reference's probe (tests/test_playback.py), in a child as the
    converter renders, through the port's copy (its child loads no
    torch)."""
    code = ("from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback "
            "import _import_mujoco\n"
            "mujoco = _import_mujoco()\n"
            "m = mujoco.MjModel.from_xml_string(\"<mujoco><worldbody>"
            "<geom type='sphere' size='.1'/></worldbody></mujoco>\")\n"
            "mujoco.Renderer(m, 16, 16).close()\n")
    env = dict(os.environ, _RPPE_RENDER_WORKER="1", PYTHONPATH=REPO)
    try:
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, env=env,
                              timeout=180).returncode == 0
    except Exception:  # noqa: BLE001 (no GL: the render tests skip)
        return False


needs_egl = pytest.mark.skipif(
    not _egl_available(), reason="no headless MuJoCo GL (EGL) available")


# ---------------------------------------------------------------------------
# the rows and their configurations
# ---------------------------------------------------------------------------


def test_rows_are_the_reference_scripts():
    assert flag.FULL == ref_flag.FULL
    assert flag.ROWS == ref_flag.ROWS
    assert list(flag.ROWS) == list(ref_flag.ROWS)
    assert (diag.BASE, diag.AUG_OFF) == (ref_diag.BASE, ref_diag.AUG_OFF)
    assert diag.ROWS == ref_diag.ROWS
    assert list(diag.ROWS) == list(ref_diag.ROWS)
    assert acc.ROWS[MJROW] == ref_acc.ROWS[MJROW]
    assert acc.FIXTURES["mjrender"] == ref_acc.FIXTURES["mjrender"]


def test_flags_are_the_reference_defaults():
    a = flag.parse_args([])
    assert (a.demos, a.demo_steps, a.image_hw, a.steps, a.batch,
            a.lookahead, a.rows) == (160, 50, 128, 4000, 128, 2, "")
    d = diag.parse_args([])
    assert (d.demos, d.demo_steps, d.steps, d.batch, d.rows,
            d.render224) == (240, 50, 5000, 128, "", False)
    assert a.device == d.device == "cuda"


def _reference_override(rel: str, name: str = "pr5") -> str:
    """The source of the dict the reference script's main passes to
    preset(name).override(**{...})."""
    src = open(os.path.join(REPO, rel)).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "override"
                and isinstance(node.func.value, ast.Call)
                and [ast.literal_eval(a) for a in node.func.value.args]
                == [name]):
            return ast.get_source_segment(src, node.keywords[0].value)
    raise AssertionError(f"no preset({name!r}).override in {rel}")


def _assert_same_config(port_cfg, jax_cfg, where, skip=()):
    got, want = port_cfg.to_dict(), jax_cfg.to_dict()
    for section, field in (("train", "ckpt_dir"), ("data", "path")) + skip:
        got[section].pop(field), want[section].pop(field)
    assert sorted(got) == sorted(want), where
    for section in want:
        if not isinstance(want[section], dict):         # the config's name
            assert got[section] == want[section], section
            continue
        assert sorted(got[section]) == sorted(want[section]), section
        for field, value in want[section].items():
            assert got[section][field] == value, \
                f"{where}: {section}.{field} {got[section][field]!r} != " \
                f"{value!r}"


@pytest.mark.parametrize("name", list(ref_flag.ROWS))
def test_battery_row_config_is_the_references(name):
    args = flag.parse_args(["--image-hw", "96", "--steps", "7",
                            "--batch", "12"])
    over = dict(ref_flag.ROWS[name])
    over.pop("_data", None)
    eval_drop = over.pop("_eval_drop", ())
    want = jax_preset("pr5").override(**eval(
        _reference_override("scripts/flagship_battery.py"),
        {"args": args, "data_path": "x", "ckpt_dir": "x", "over": over}))
    cfg, drop = flag.row_config(args, name, "ckpt")
    _assert_same_config(cfg, want, name)
    assert drop == eval_drop
    assert cfg.data.path == ("rendered" if ref_flag.ROWS[name].get("_data")
                             == "rendered" else "rendered_la2")


@pytest.mark.parametrize("name", list(ref_diag.ROWS))
def test_rot_diag_row_config_is_the_references(name):
    args = diag.parse_args(["--steps", "7", "--batch", "12"])
    over = dict(ref_diag.ROWS[name])
    data = over.pop("_data", "rendered")
    want = jax_preset("pr5").override(**eval(
        _reference_override("scripts/flagship_rot_diag.py"),
        {"args": args, "data_path": "x", "ckpt_dir": "x", "over": over}))
    cfg = diag.row_config(args, name, "ckpt")
    _assert_same_config(cfg, want, name)
    assert cfg.data.path == data


def test_mjrender_row_config_is_the_references():
    """The accuracy battery's rendered row: preset pr3 with the
    reference's settings and the row's proprio and target keys; the port
    also sets dist.num_devices 1 (pr3's 0 takes every visible card)."""
    args = acc.parse_args(["--steps", "7", "--batch", "12"])
    cfg, drop, val = acc.row_config(args, MJROW, {"mjrender": "m"}, "c")
    over = dict(ref_acc.ROWS[MJROW])
    over.pop("_fixture")
    want = jax_preset("pr3").override(**eval(
        _reference_override("scripts/accuracy_artifact.py", "pr3"),
        {"args": args, "row_fixture": "x", "ckpt_dir": "x", "over": over}))
    _assert_same_config(cfg, want, MJROW, skip=(("dist", "num_devices"),))
    assert cfg.dist.num_devices == 1
    assert cfg.data.path == "m" and drop == () and val == ""
    assert (cfg.model.proprio_dim, cfg.data.proprio_key,
            cfg.data.target_key) == (4, "obs/qpos,obs/qvel", "obs/object")


# ---------------------------------------------------------------------------
# arrays, the .npz and the lookahead, without a render
# ---------------------------------------------------------------------------


def _write_file(path, demos, attrs):
    """demos as an HDF5 demo file, as render_playback_dataset lays one
    out (datasets under each demo's group, num_samples on it)."""
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for k, v in attrs.items():
            data.attrs[k] = v
        for d in demos:
            g = data.create_group(d["name"])
            for k, v in d["attrs"].items():
                g.attrs[k] = v
            for key, arr in d["datasets"].items():
                g[key] = arr
    return path


def _assert_same_demos(got, want):
    assert [d["name"] for d in got] == [d["name"] for d in want]
    for a, b in zip(got, want):
        assert sorted(a["datasets"]) == sorted(b["datasets"]), a["name"]
        for key, arr in b["datasets"].items():
            x = a["datasets"][key]
            assert (x.dtype, x.shape) == (arr.dtype, arr.shape), key
            assert x.tobytes() == arr.tobytes(), key
        assert a["attrs"] == b["attrs"], a["name"]


@pytest.mark.parametrize("compress", [True, False])
def test_npz_round_trip_of_standin_demos(tmp_path, compress):
    demos, attrs = flag.standin_demos(3, 6, 24, seed=4)
    assert sorted(demos[0]["datasets"]) == [
        "obs/agentview_image", "obs/object", "obs/qpos", "obs/qvel",
        "obs/robot0_eye_in_hand_image"]
    assert demos[0]["datasets"]["obs/object"].shape == (6, 7)
    path = str(tmp_path / "d.npz")
    assert save_demos_npz(path, demos, attrs, compress=compress) == path
    assert os.listdir(tmp_path) == ["d.npz"]
    got, got_attrs = load_demos_npz(path)
    _assert_same_demos(got, demos)
    assert got_attrs == attrs
    # and through an HDF5 file: demo_file_arrays reads it back
    back, back_attrs = demo_file_arrays(
        _write_file(str(tmp_path / "d.hdf5"), demos, attrs))
    _assert_same_demos(back, demos)
    assert back_attrs == attrs


@pytest.mark.parametrize("k", [0, 2, 5])
def test_lookahead_on_arrays_is_the_reference_file(tmp_path, k):
    """derive_lookahead on arrays against the reference's on an HDF5
    file of the same demos (stand-in arrays, 12 demos, natural order
    past demo_9)."""
    demos, attrs = flag.standin_demos(12, 7, 16, seed=1)
    src = _write_file(str(tmp_path / "r.hdf5"), demos, attrs)
    dst = str(tmp_path / "la.hdf5")
    ref_flag.derive_lookahead(src, dst, k)
    want, want_attrs = demo_file_arrays(dst)
    got, got_attrs = flag.derive_lookahead(demos, attrs, k)
    _assert_same_demos(got, want)
    assert got_attrs == want_attrs and got_attrs["lookahead_k"] == k


def test_encoded_frames_are_not_carried(tmp_path):
    path = write_demo_fixture(str(tmp_path / "j.hdf5"), n_demos=1, steps=2,
                              image_hw=16, encoding="jpeg")
    with pytest.raises(ValueError, match="encoded frames"):
        demo_file_arrays(path)


# ---------------------------------------------------------------------------
# a tiny render: the file route against the arrays
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def render(tmp_path_factory):
    """--render-only of the battery at 4 demos x 8 steps, 32 px: its
    directory, the .npz it names and the reference's lookahead file of
    the render. Under xdist the workers share one render, made under a
    lock in the run's base temporary directory (the script's own
    exists-guards reuse the files)."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        root = tmp_path_factory.getbasetemp().parent
        out = root / "flag_render"
        lock_path = root / "flag_render.lock"
    else:
        out = tmp_path_factory.mktemp("flag_render")
        lock_path = out / "lock"
    la = os.path.join(out, "rendered_la2.hdf5")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        got = flag.main(["--render-only", "--out", str(out), "--image-hw",
                         "32"] + TINY)
        assert {"rendered.hdf5", "rendered.npz", "states.hdf5"} <= set(
            os.listdir(out))
        if not os.path.exists(la):
            ref_flag.derive_lookahead(os.path.join(out, "rendered.hdf5"),
                                      la + ".tmp", 2)
            os.replace(la + ".tmp", la)
    return str(out), got["frames"], la


@needs_egl
def test_rendered_npz_is_the_rendered_file(render):
    out, npz, la = render
    demos, attrs = load_demos_npz(npz)
    want, want_attrs = demo_file_arrays(os.path.join(out, "rendered.hdf5"))
    _assert_same_demos(demos, want)
    assert attrs == want_attrs and attrs["rendered_by"]
    d = demos[0]["datasets"]
    assert d["obs/agentview_image"].shape == (8, 32, 32, 3)
    assert d["obs/robot0_eye_in_hand_image"].dtype == np.uint8
    assert (d["obs/qpos"].shape, d["obs/qvel"].shape,
            d["obs/object"].shape) == ((8, 4), (8, 4), (8, 7))
    # the raw file, read without the port: the same bytes
    with h5py.File(os.path.join(out, "rendered.hdf5"), "r") as f:
        for demo in demos:
            for key, arr in demo["datasets"].items():
                assert f["data"][demo["name"]][key][()].tobytes() == \
                    arr.tobytes()


@needs_egl
def test_rendered_lookahead_is_the_reference_file(render):
    _, npz, la = render
    got, got_attrs = flag.derive_lookahead(*load_demos_npz(npz), 2)
    want, want_attrs = demo_file_arrays(la)
    _assert_same_demos(got, want)
    assert got_attrs == want_attrs


def _store_cfg(**over):
    args = flag.parse_args(["--image-hw", "32", "--batch", "4"])
    cfg, _ = flag.row_config(args, "pr5-full (composition)", "c")
    return cfg.override(**over)


@needs_egl
@pytest.mark.parametrize("over", [
    {},
    {"data.device_cache": False, "data.augment_device": False,
     "data.cache_layout": "replicated"},
    {"model.temporal_frames": 1, "data.augment": False,
     "data.augment_device": False, "data.crop_margin": 0},
], ids=["composition (cache indices)", "host augmentation", "aug off"])
def test_npz_route_batches_are_the_file_routes(render, over):
    _, npz, la = render
    fixtures = flag.fixtures_of(flag.parse_args([]), *load_demos_npz(npz))
    cfg = _store_cfg(**over)
    for split in ("train", "val"):
        mem = build_dataset(cfg, split, fixtures=fixtures)
        disk = build_dataset(cfg.override(**{"data.path": la}), split)
        assert isinstance(mem, MemoryDemoStore)
        assert type(disk).__name__ == "HDF5DemoStore"
        assert mem._demo_keys == disk._demo_keys and len(mem) == len(disk)
        assert mem.emit_image_indices == disk.emit_image_indices
        for a, b in ((mem.proprio_stats(), disk.proprio_stats()),
                     (mem.frames_per_demo(), disk.frames_per_demo())):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        idx = np.arange(len(mem))
        for seed in (0, 5):
            got = mem.get_batch(idx, augment=cfg.data.augment, seed=seed)
            want = disk.get_batch(idx, augment=cfg.data.augment, seed=seed)
            _assert_batches_equal(got, want)
        if cfg.data.device_cache:
            hw = cfg.model.image_size + 2 * cfg.data.crop_margin
            _assert_batches_equal(mem.build_resized_cache(hw),
                                  disk.build_resized_cache(hw))


def _assert_batches_equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_batches_equal(a[k], b[k], f"{where}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), where
    assert a.tobytes() == b.tobytes(), where


@needs_egl
def test_tiny_battery_row_from_frames(render, tmp_path):
    """The composition row and its dead-camera evals on the CPU from
    --render-only's arrays; results.json in the reference's keys."""
    _, npz, _ = render
    got = flag.main(TINY_RUN + ["--frames", npz, "--out", str(tmp_path),
                                "--rows", "pr5-full (composition)"])
    with open(tmp_path / "results.json") as f:
        assert json.load(f) == got
    with open(os.path.join(REPO, "docs/artifacts/flagship_battery_r4.json")
              ) as f:
        ref = json.load(f)
    row = "pr5-full (composition)"
    keys = [row, f"{row} [dead agentview]",
            f"{row} [dead robot0_eye_in_hand]"]
    assert list(got) == keys
    for key in keys:
        assert sorted(got[key]) == sorted(ref[key]), key
        assert all(math.isfinite(got[key][m])
                   for m in ("pos_mae_cm", "rot_mae_deg"))
    assert got[row]["steps"] == 2 and got[row]["held_out_demos"] == 0
    assert os.path.isdir(tmp_path / "pr5-full_composition" / "best")


def test_rot_diag_rows_from_frames(tmp_path, monkeypatch):
    """The grid's run over --frames arrays (stand-in demos): each row's
    config and in-memory dataset go to the shared train_and_score (run
    for real by the battery's rows above, stubbed here), the 224 px rows
    wait for 224 px frames, rot_diag.json takes the reference's keys
    with the demo count read from the arrays."""
    npz = save_demos_npz(str(tmp_path / "f.npz"),
                         *flag.standin_demos(6, 5, 16, seed=2))
    seen = []

    def train_and_score(cfg, fixtures, eval_drop, device):
        seen.append((cfg, sorted(fixtures), len(fixtures[cfg.data.path]),
                     eval_drop, device.type))
        return {"metrics": {"pos_mae_cm": 12.345, "rot_mae_deg": 40.0},
                "dead": {}, "seconds": 0.0}

    monkeypatch.setattr(flag, "accuracy_script", lambda: types.SimpleNamespace(
        train_and_score=train_and_score))
    monkeypatch.setattr(diag, "_battery", lambda: flag)
    rows = ["diag lowres-64 (aug-on quat)", "diag 224 (aug-on quat)",
            "diag rot6d seed1"]
    got = diag.main(["--device", "cpu", "--steps", "3", "--frames", npz,
                     "--out", str(tmp_path / "run"), "--rows",
                     ",".join(rows)] + TINY)
    assert list(got) == [rows[0], rows[2]]
    assert got[rows[0]] == {"pos_mae_cm": 12.35, "rot_mae_deg": 40.0,
                            "steps": 3, "held_out_demos": 1}
    assert [s[1:] for s in seen] == [(["rendered"], 6, (), "cpu")] * 2
    assert (seen[0][0].model.image_size, seen[1][0].train.seed,
            seen[1][0].model.rot_rep) == (64, 1, "rot6d")
    assert seen[0][0].train.ckpt_dir == str(
        tmp_path / "run" / "diag_diag_lowres-64_aug-on_quat")
    with open(tmp_path / "run" / "rot_diag.json") as f:
        assert json.load(f) == got


@needs_egl
def test_mjrender_row_renders_then_trains_from_frames(tmp_path):
    """The accuracy battery's rendered row: --render-only writes the
    reference's fixture (write_states_fixture seed 7, agentview) as
    arrays, then the row trains from --frames on the CPU."""
    size = ["--demos", "4", "--demo-steps", "8", "--image-hw", "32"]
    out = acc.main(size + ["--render-only", "--out", str(tmp_path)])
    npz = out["frames"]
    assert npz == str(tmp_path / "demos_mjrender.npz")
    demos, attrs = load_demos_npz(npz)
    _assert_same_demos(demos, demo_file_arrays(
        str(tmp_path / "demos_mjrender.hdf5"))[0])
    assert sorted(demos[0]["datasets"]) == [
        "obs/agentview_image", "obs/object", "obs/qpos", "obs/qvel"]
    assert demos[0]["datasets"]["obs/qpos"].shape == (8, 2)
    got = acc.main(size + ["--steps", "2", "--batch", "4", "--device", "cpu",
                           "--frames", npz, "--rows", MJROW, "--out",
                           str(tmp_path / "run")])
    assert list(got) == [MJROW]
    assert sorted(got[MJROW]) == ["held_out_demos", "pos_mae_cm",
                                  "rot_mae_deg", "steps"]
    assert math.isfinite(got[MJROW]["pos_mae_cm"])


# ---------------------------------------------------------------------------
# without MuJoCo, and the card's path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("script", ["battery", "rot diag", "accuracy"])
def test_without_mujoco_or_frames_each_script_names_both(tmp_path,
                                                        monkeypatch, script):
    monkeypatch.setitem(sys.modules, "mujoco", None)    # import fails
    out = ["--out", str(tmp_path), "--device", "cpu"]
    main, argv = {
        "battery": (flag.main, out),
        "rot diag": (diag.main, out),
        "accuracy": (acc.main, out + ["--rows", MJROW]),
    }[script]
    with pytest.raises(ValueError) as e:
        main(argv)
    assert "mujoco" in str(e.value) and "--frames" in str(e.value)
    with pytest.raises(ValueError, match="mujoco"):
        main(argv + ["--render-only"])
    assert os.listdir(tmp_path) == []


def test_the_frames_path_loads_no_jax_h5py_or_mujoco(tmp_path):
    """The three scripts' --frames routes in a fresh process, over
    stand-in arrays: none of the modules the card's host lacks loads."""
    scripts = os.path.join(REPO, "scripts")
    code = (
        "import sys, importlib.util\n"
        "def load(n):\n"
        f"    spec = importlib.util.spec_from_file_location(n, {scripts!r} + '/' + n + '.py')\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    return m\n"
        "flag = load('torch_flagship_battery')\n"
        "diag = load('torch_flagship_rot_diag')\n"
        "acc = load('torch_accuracy_artifact')\n"
        "from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store"
        " import save_demos_npz, load_demos_npz\n"
        "npz = save_demos_npz('f.npz', *flag.standin_demos(5, 6, 40))\n"
        "args = flag.parse_args(['--frames', npz, '--image-hw', '32',"
        " '--batch', '4'])\n"
        "fx = flag.fixtures_of(args, *flag.load_frames(args))\n"
        "cfg, _ = flag.row_config(args, 'pr5-full (composition)', 'c')\n"
        "from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline"
        " import build_dataset\n"
        "ds = build_dataset(cfg, 'train', fixtures=fx)\n"
        "ds.build_resized_cache(40)\n"
        "print(acc.chance_level(cfg, fx)['pos_mae_cm'] > 0)\n"
        "dcfg = diag.row_config(diag.parse_args(['--frames', npz]),"
        " 'diag base (aug-on quat)', 'c')\n"
        "build_dataset(dcfg, 'val', fixtures={'rendered': fx['rendered']})\n"
        "aargs = acc.parse_args(['--frames', npz])\n"
        "print(len(acc.fixture_demos(aargs, 'mjrender')))\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop\n"
        "banned = ('jax', 'flax', 'optax', 'h5py', 'cv2', 'matplotlib',"
        " 'mujoco', 'rgb_proprioceptive_pose_estimator_tpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in banned))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "5", "[]"]
