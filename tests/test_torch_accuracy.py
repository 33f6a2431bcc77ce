"""The port's accuracy battery (``scripts/torch_accuracy_artifact.py``)
on the CPU, held against the JAX package and against the port's own file
route.

- ``data/hdf5_store.demo_fixture_arrays`` yields exactly what the JAX
  package's ``write_demo_fixture`` file holds, for each fixture of the
  battery (datasets and attributes bit for bit), and the port's
  ``write_demo_fixture`` writes that file byte for byte;
- ``MemoryDemoStore`` over those arrays is the port's ``HDF5DemoStore``
  over the file: split, statistics, batches with and without
  augmentation, temporal windows and the device-cache interface, all
  exact;
- the script's ``FIXTURES``/``ROWS`` are the reference script's;
- two rows end to end at pr3 (32 px, 5 demos, 6 train steps, batch 8):
  the in-memory route's results.json equals, exactly, the one the port's
  ``api.train`` + ``api.evaluate`` give on the HDF5 files;
- without mujoco and --frames the MuJoCo-rendered fixture is refused
  naming both, and the script's
  card path loads none of JAX, the JAX package, h5py, optax, cv2,
  matplotlib or mujoco.

Runs torch on one intra-op thread."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from rgb_proprioceptive_pose_estimator_tpu.data.hdf5_store import (
    write_demo_fixture as jax_write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch import api, preset
from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
    MemoryDemoStore,
    demo_fixture_arrays,
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    build_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(n_demos=3, steps=8, image_hw=32)
STORE_SIZE = dict(n_demos=10, steps=8, image_hw=40)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


acc = _load("torch_accuracy_artifact", "scripts/torch_accuracy_artifact.py")
FIXTURE_NAMES = [f for f in acc.FIXTURES if f != "mjrender"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fixture_kwargs(name):
    """The battery's write_demo_fixture kwargs of fixture ``name`` (the
    reference script's fixture_path)."""
    kw = dict(acc.FIXTURES[name])
    kw.setdefault("cameras", ("agentview",))
    kw.setdefault("seed", 7)
    return kw


def _read_file(path):
    """{demo: (datasets, attrs)} of a fixture file, in file order."""
    out = {}
    with h5py.File(path, "r") as f:
        for name, g in f["data"].items():
            ds = {}
            g.visititems(lambda k, v: ds.__setitem__(k, v[()]) if isinstance(
                v, h5py.Dataset) else None)
            out[name] = (ds, dict(g.attrs))
    return out


@pytest.mark.parametrize("fixture", FIXTURE_NAMES)
def test_fixture_arrays_are_the_jax_file_bit_for_bit(tmp_path, fixture):
    kw = _fixture_kwargs(fixture)
    ref_path = str(tmp_path / "jax.hdf5")
    jax_write_demo_fixture(ref_path, **SIZE, **kw)
    ref = _read_file(ref_path)
    demos = list(demo_fixture_arrays(**SIZE, **kw))
    assert [d["name"] for d in demos] == list(ref)
    for d in demos:
        ref_ds, ref_attrs = ref[d["name"]]
        assert sorted(d["datasets"]) == sorted(ref_ds)
        for key, arr in d["datasets"].items():
            assert arr.dtype == ref_ds[key].dtype, key
            assert arr.shape == ref_ds[key].shape, key
            assert arr.tobytes() == ref_ds[key].tobytes(), key
        assert d["attrs"] == ref_attrs
    # and the port's writer, now built on the arrays, writes the same file
    port_path = str(tmp_path / "port.hdf5")
    write_demo_fixture(port_path, **SIZE, **kw)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("extra", [{"encoding": "jpeg"},
                                   {"encoding": "png",
                                    "filter_keys": {"odd": [1]}}],
                         ids=["jpeg", "png with a filter key"])
def test_file_only_options_write_the_jax_file(tmp_path, extra):
    kw = dict(_fixture_kwargs("occl"), **extra)
    jax_write_demo_fixture(str(tmp_path / "jax.hdf5"), **SIZE, **kw)
    write_demo_fixture(str(tmp_path / "port.hdf5"), **SIZE, **kw)
    assert (tmp_path / "jax.hdf5").read_bytes() == (
        tmp_path / "port.hdf5").read_bytes()


# ---------------------------------------------------------------------------
# the in-memory store against the file store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def store_fixture(tmp_path_factory):
    """The occl fixture (two cameras) at 10 demos: its arrays and a file
    written from them."""
    kw = _fixture_kwargs("occl")
    path = str(tmp_path_factory.mktemp("acc_store") / "occl.hdf5")
    write_demo_fixture(path, **STORE_SIZE, **kw)
    return {"occl": list(demo_fixture_arrays(**STORE_SIZE, **kw))}, path


def _store_cfg(**over):
    return preset("pr3").override(**{
        "model.image_size": 24, "model.use_proprio": True,
        "model.cameras": ("agentview", "robot0_eye_in_hand"),
        "data.val_fraction": 0.2, "data.batch_size": 8, **over})


def _pair(store_fixture, split, **over):
    fixtures, path = store_fixture
    cfg = _store_cfg(**over)
    mem = build_dataset(cfg.override(**{"data.path": "occl"}), split,
                        fixtures=fixtures)
    disk = build_dataset(cfg.override(**{"data.path": path}), split)
    assert isinstance(mem, MemoryDemoStore)
    assert type(disk).__name__ == "HDF5DemoStore"
    return mem, disk


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where


def test_memory_store_split_and_statistics(store_fixture):
    keys = {}
    for split in ("train", "val", "all"):
        mem, disk = _pair(store_fixture, split)
        assert len(mem) == len(disk)
        assert mem._demo_keys == disk._demo_keys
        keys[split] = set(mem._demo_keys)
        _assert_same(mem.proprio_stats(), disk.proprio_stats(), split)
        _assert_same(mem._index, disk._index, split)
    # demo granularity: 2 of 10 demos held out, disjoint from train
    assert len(keys["val"]) == 2 and len(keys["train"]) == 8
    assert keys["train"] | keys["val"] == keys["all"]
    assert not keys["train"] & keys["val"]


@pytest.mark.parametrize("case", [
    ({}, False),
    ({"data.hflip_prob": 0.5, "data.hflip_pose_mirror": True,
      "data.hflip_mirror_center": 0.5, "data.crop_scale": (0.8, 1.0)}, True),
    ({"model.temporal_frames": 3}, True),
    ({"data.device_cache": True, "data.augment_device": True,
      "data.crop_margin": 4}, True),
    ({"data.device_cache": True, "data.augment": False,
      "model.temporal_frames": 3}, False),
], ids=["augment off", "augment on, mirrored flips", "3-frame windows",
        "device cache indices", "device cache 3-frame indices"])
def test_memory_store_batches_are_the_files(store_fixture, case):
    over, augment = case
    for split in ("train", "val"):
        mem, disk = _pair(store_fixture, split, **over)
        assert mem.emit_image_indices == disk.emit_image_indices
        idx = np.random.RandomState(3).permutation(len(mem))[:16]
        for seed in (0, 11):
            _assert_same(mem.get_batch(idx, augment=augment, seed=seed),
                         disk.get_batch(idx, augment=augment, seed=seed),
                         f"{split} seed {seed}")


def test_memory_store_device_cache_interface(store_fixture):
    mem, disk = _pair(store_fixture, "train", **{"data.device_cache": True,
                                                 "data.augment_device": True})
    _assert_same(mem.frames_per_demo(), disk.frames_per_demo())
    _assert_same(mem.sample_demos(), disk.sample_demos())
    for hw in (24, 32):
        _assert_same(mem.build_resized_cache(hw), disk.build_resized_cache(hw),
                     f"{hw} px")


def test_memory_store_refuses_an_unknown_fixture(store_fixture):
    fixtures, _ = store_fixture
    with pytest.raises(KeyError, match="no in-memory fixture 'plain'"):
        MemoryDemoStore("plain", fixtures=fixtures)


def test_chance_level_is_the_mean_predictor(store_fixture):
    """The train split's mean pose scored on the held-out split, against
    numpy: position by hand, rotation through the sign-free mean
    quaternion (every train quaternion's sign flipped gives the same)."""
    fixtures, _ = store_fixture
    cfg = _store_cfg(**{"data.path": "occl"})
    got = acc.chance_level(cfg, fixtures)
    train = build_dataset(cfg, "train", fixtures=fixtures)
    val = build_dataset(cfg, "val", fixtures=fixtures)
    pos, _ = acc.sample_labels(train)
    vpos, _ = acc.sample_labels(val)
    want = np.linalg.norm(vpos - pos.mean(0), axis=-1).mean() * 100
    assert got["pos_mae_cm"] == pytest.approx(want, rel=1e-5)
    assert 0 < got["rot_mae_deg"] <= 180
    flipped = [{**d, "datasets": {**d["datasets"], "obs/object": np.concatenate(
        [d["datasets"]["obs/object"][:, :3], -d["datasets"]["obs/object"][:, 3:7],
         d["datasets"]["obs/object"][:, 7:]], axis=1)}} for d in fixtures["occl"]]
    assert acc.chance_level(cfg, {"occl": flipped})["rot_mae_deg"] == \
        pytest.approx(got["rot_mae_deg"], abs=1e-3)


# ---------------------------------------------------------------------------
# the script
# ---------------------------------------------------------------------------


def test_fixtures_and_rows_are_the_reference_scripts():
    ref = _load("accuracy_artifact_reference", "scripts/accuracy_artifact.py")
    assert acc.FIXTURES == ref.FIXTURES
    assert acc.ROWS == ref.ROWS
    assert list(acc.ROWS) == list(ref.ROWS)
    assert not set(acc.PORT_ROWS) & set(ref.ROWS)
    assert set(acc.REFERENCE) <= set(ref.ROWS)
    assert len(acc.REFERENCE) == 14


E2E_ROWS = ("image-only", "image+noisy-pose-proprio (cam-dropout)")
E2E_ARGS = ["--device", "cpu", "--demos", "5", "--demo-steps", "10",
            "--image-hw", "40", "--steps", "6", "--batch", "8",
            "--set", "model.image_size=32"]


def _file_route(args, root):
    """The rows through the port's api.train + api.evaluate on fixture
    files the port's write_demo_fixture writes, formatted as the
    reference script formats them."""
    results = {}
    paths = {}
    root.mkdir()
    for f in FIXTURE_NAMES:
        paths[f] = str(root / f"demos_{f}.hdf5")
        write_demo_fixture(paths[f], n_demos=args.demos,
                           steps=args.demo_steps, image_hw=args.image_hw,
                           **_fixture_kwargs(f))

    def fmt(m):
        return {"pos_mae_cm": round(m["pos_mae_cm"], 2),
                "rot_mae_deg": round(m["rot_mae_deg"], 2),
                "steps": args.steps, "held_out_demos": int(args.demos * 0.2)}

    for name in E2E_ROWS:
        ckpt = str(root / name.split()[0].replace("+", "_"))
        cfg, drop, _ = acc.row_config(args, name, paths, ckpt)
        api.train(cfg, device="cpu")
        best = cfg.override(**{"train.ckpt_dir": f"{ckpt}/best"})
        results[name] = fmt(api.evaluate(best, split="val", device="cpu"))
        for cam in drop:
            results[f"{name} [dead {cam}]"] = fmt(api.evaluate(
                best, split="val", drop_cameras=(cam,), device="cpu"))
    return results


def test_two_rows_in_memory_equal_the_file_route(tmp_path):
    out = tmp_path / "mem"
    argv = E2E_ARGS + ["--out", str(out), "--rows", ",".join(E2E_ROWS)]
    try:
        got = acc.main(argv)
        with open(out / "results.json") as f:
            assert json.load(f) == got
        with open(out / "runs.json") as f:
            runs = json.load(f)
        want = _file_route(acc.parse_args(argv), tmp_path / "files")
    finally:
        # the runs' checkpoints (ResNet-18 with AdamW state, ~1 GB in all)
        for d in tmp_path.glob("*/*"):
            if d.is_dir():
                shutil.rmtree(d)
    assert set(got) == {"image-only",
                        "image+noisy-pose-proprio (cam-dropout)",
                        "image+noisy-pose-proprio (cam-dropout) "
                        "[dead agentview]"}
    assert got == want
    assert runs["image-only"]["card"] == "cpu"
    assert runs["image-only"]["dtype"] == "float32"
    assert runs["image-only"]["train_seed"] == 0


def test_seed_keys_the_row_and_collect_bands_it(tmp_path):
    """--seed sets train.seed and keys the row; --collect widens each
    row's band by the seeds' spread and scores the readings."""
    args = acc.parse_args(E2E_ARGS + ["--seed", "2"])
    cfg, _, _ = acc.row_config(args, "image-only", {"plain": "p"},
                               str(tmp_path))
    assert cfg.train.seed == 2 and acc.row_key(args, "image-only") == \
        "image-only (seed2)"
    runs = {"image-only": 8.0, "image-only (seed1)": 11.5,
            "proprio-only (control)": 40.0}
    for i, (key, pos) in enumerate(runs.items()):
        d = tmp_path / f"run{i}"
        d.mkdir()
        entry = {"pos_mae_cm": pos, "rot_mae_deg": 30.0, "steps": 3000,
                 "held_out_demos": 8}
        (d / "results.json").write_text(json.dumps({
            key: entry, f"{key} [dead agentview]": entry}))
        (d / "runs.json").write_text(json.dumps({key: {"seconds": 1.0,
                                                       "card": "c"}}))
    art = tmp_path / "art.json"
    out = acc.main(["--collect"] + [str(tmp_path / f"run{i}")
                                    for i in range(3)]
                   + ["--artifact", str(art)])
    assert json.loads(art.read_text()) == json.loads(json.dumps(out))
    row = out["table"]["image-only"]
    assert row["port_pos_mae_cm"] == [8.0, 11.5] and row["runs"] == 2
    assert row["in_band"]                # 8.84 inside [8 - 2, 11.5 + 2]
    assert not out["table"]["proprio-only (control)"]["in_band"]  # 42.7 ±8
    assert out["table"]["dual-cam (occluded)"]["port"] is None
    assert out["rows_in_band"] == "1 of 14"
    # a dead-camera score shares its row's run and is no row of its own
    assert out["runs"]["image-only (seed1) [dead agentview]"]["card"] == "c"
    assert out["cards"] == ["c"]
    assert out["readings"]["proprio-only at chance, >= 3x image-only"]
    assert out["readings"]["dual-cam beats single-cam (occluded)"] is None


def test_mjrender_is_refused_naming_mujoco(tmp_path, monkeypatch):
    """Without mujoco and without --frames the rendered row is refused
    naming both (with either, it renders or reads its arrays:
    tests/test_torch_flagship.py)."""
    monkeypatch.setitem(sys.modules, "mujoco", None)    # import fails
    with pytest.raises(ValueError, match="mujoco.*--frames"):
        acc.main(E2E_ARGS + ["--out", str(tmp_path),
                             "--rows", "image+qpos (mujoco-rendered)"])


def test_the_card_path_loads_no_jax_h5py_or_mujoco(tmp_path):
    """The script, its fixtures and the in-memory stores in a fresh
    process: none of the modules the card's host lacks is loaded."""
    code = (
        "import sys, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('a', {os.path.join(REPO, 'scripts/torch_accuracy_artifact.py')!r})\n"
        "acc = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(acc)\n"
        "args = acc.parse_args(['--demos', '5', '--demo-steps', '4',"
        " '--image-hw', '32', '--set', 'model.image_size=24'])\n"
        "fx = {'occl': acc.fixture_demos(args, 'occl')}\n"
        "cfg, _, _ = acc.row_config(args, 'dual-cam (occluded)',"
        " {'occl': 'occl', 'plain': 'plain'}, 'ckpt')\n"
        "from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline"
        " import build_dataset\n"
        "ds = build_dataset(cfg, 'train', fixtures=fx)\n"
        "ds.build_resized_cache(32)\n"
        "print(acc.chance_level(cfg, fx)['pos_mae_cm'] > 0)\n"
        "import rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop\n"
        "banned = ('jax', 'flax', 'optax', 'h5py', 'cv2', 'matplotlib',"
        " 'mujoco', 'rgb_proprioceptive_pose_estimator_tpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in banned))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["True", "[]"]
