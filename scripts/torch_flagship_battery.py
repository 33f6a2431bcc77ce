#!/usr/bin/env python3
"""The flagship battery of the PyTorch/CUDA port: the rows of the JAX
package's ``scripts/flagship_battery.py``, the full pr5 composition and
its single-feature ablations, trained on MuJoCo-rendered dual-camera
demos with lookahead labels and scored on held-out demos.

Data: the flagship playback scene (``data/playback.py``
``write_flagship_states_fixture``, seed 42, cube spin 0.10 rad/step) --
a 4-dof arm with a wrist camera servoing toward a constant-velocity
cube, agentview occluded by a wall on part of the workspace -- rendered
by ``render_playback_dataset`` with both cameras, then relabeled with
lookahead poses (label[t] = cube pose at t + K, ``derive_lookahead``).
Each row is ``preset("pr5")`` with the reference's settings (20% of the
demos held out, the device cache and device augmentation, cosine LR, an
eval every 500 steps, the best checkpoint on held-out pos MAE) and the
row's own overrides, trained through ``engine.loop.train_on`` and scored
with ``api.evaluate_on`` (``scripts/torch_accuracy_artifact.py``'s
``train_and_score``), once more with each ``_eval_drop`` camera dead.

Rendering needs ``mujoco`` and ``h5py``; training needs the card. The two
halves meet in one ``.npz`` of the rendered demos that numpy alone reads:

    # where mujoco and EGL are: states.hdf5, rendered.hdf5, rendered.npz
    python3 scripts/torch_flagship_battery.py --render-only --out DIR
    # on the card
    python3 scripts/torch_flagship_battery.py --frames DIR/rendered.npz \\
        [--steps 4000] [--out DIR2] [--rows "pr5-full (composition)"]

Without ``--frames`` the script renders into ``--out`` first, as the
reference does, where ``mujoco`` and ``h5py`` are; without them it raises
naming both them and ``--frames``. The lookahead labels are derived from
the arrays in memory, bit for bit the reference's derived file.
``results.json`` in ``--out`` accumulates the rows in the reference's
keys and rounding (``docs/artifacts/flagship_battery_r4.json``).
``--device cpu`` exists for the tests.
"""

from __future__ import annotations

# runnable as python3 scripts/torch_flagship_battery.py from the repo root
# without PYTHONPATH: the package lives one directory above this file
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import importlib.util
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the full composition: exactly what the pr5 preset ships (lstm +
# camera_dropout=0.15 + proprio_normalize=True) plus the serving-path
# EMA/recal and the sharded cache layout (the reference's, as is)
FULL = {
    "train.ema_decay": 0.999,
    "train.ema_bn_recal_batches": 30,
    "data.cache_layout": "sharded",
}

# row name -> config overrides (the reference's, as is); "_data" and
# "_eval_drop" are the battery's own keys
ROWS = {
    "pr5-full (composition)": {
        **FULL, "_eval_drop": ("agentview", "robot0_eye_in_hand")},
    # each ablation = composition minus ONE feature
    "abl single-cam (agentview)": {
        **FULL, "model.cameras": ("agentview",)},
    "abl single-cam (wrist)": {
        **FULL, "model.cameras": ("robot0_eye_in_hand",)},
    "abl single-frame": {**FULL, "model.temporal_frames": 1},
    "abl channel-stack": {**FULL, "model.temporal_mode": "channel"},
    "abl no-camera-dropout": {
        **FULL, "model.camera_dropout": 0.0,
        "_eval_drop": ("agentview", "robot0_eye_in_hand")},
    "abl raw-proprio": {**FULL, "model.proprio_normalize": False},
    "abl no-proprio": {**FULL, "model.use_proprio": False},
    # without proprio, velocity is only recoverable across frames: this
    # row against "abl no-proprio" (LSTM) isolates what temporal context
    # is worth when nothing else carries the velocity
    "abl no-proprio single-frame": {
        **FULL, "model.use_proprio": False, "model.temporal_frames": 1},
    "abl no-ema": {"data.cache_layout": "sharded"},
    # context row: same data WITHOUT lookahead labels (current pose)
    "ref current-pose (composition)": {**FULL, "_data": "rendered"},
    # the continuous-rotation head inside the full composition
    "pr5-full (rot6d)": {**FULL, "model.rot_rep": "rot6d"},
}

CAMERAS = ("agentview", "robot0_eye_in_hand")


def accuracy_script():
    """scripts/torch_accuracy_artifact.py, whose training and scoring
    this battery shares."""
    spec = importlib.util.spec_from_file_location(
        "torch_accuracy_artifact",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_accuracy_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def derive_lookahead(demos: Sequence[Dict], attrs: Dict, k: int
                     ) -> Tuple[List[Dict], Dict]:
    """The reference's derive_lookahead on arrays: each demo's
    obs/object[t] becomes the pose at t + k and every other obs/ dataset
    keeps its first T - k steps (T the demo's num_samples), so each label
    exists; images and proprio stay at time t. Exactly what the
    reference's derived file holds: its obs/ datasets, num_samples, and
    the data attributes with lookahead_k."""
    out = []
    for d in demos:
        t = int(d["attrs"]["num_samples"]) - k
        out.append({"name": d["name"], "attrs": {"num_samples": t},
                    "datasets": {
                        key: (arr[k:] if key == "obs/object" else arr[:t])
                        for key, arr in d["datasets"].items()
                        if key.startswith("obs/")}})
    return out, {**attrs, "lookahead_k": k}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demos", type=int, default=160)
    ap.add_argument("--demo-steps", type=int, default=50)
    ap.add_argument("--image-hw", type=int, default=128)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lookahead", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rppe_flag"))
    ap.add_argument("--rows", default="",
                    help="comma-separated subset of rows to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu is for the tests")
    ap.add_argument("--render-only", action="store_true",
                    help="write states.hdf5, rendered.hdf5 and rendered.npz "
                         "into --out and stop (needs mujoco, h5py)")
    ap.add_argument("--frames", default="",
                    help="the rendered demos' .npz (--render-only's)")
    return ap.parse_args(argv)


def render_frames(out: str, demos: int, demo_steps: int, image_hw: int,
                  name: str = "rendered") -> str:
    """The flagship scene's states (``states.hdf5`` in ``out``) rendered
    with both cameras at ``image_hw`` (``<name>.hdf5``), then as arrays
    (``<name>.npz``), each file made only where it is missing (a reused
    states file keeps its own demo count); returns the ``.npz`` path.
    Raises ValueError naming mujoco/h5py where this host lacks them."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data import playback
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        demo_file_arrays,
        save_demos_npz,
    )

    missing = playback.missing_render_modules()
    if missing:
        raise ValueError(
            f"the flagship demos are rendered by MuJoCo and written with "
            f"h5py, and this host lacks {' and '.join(missing)}: pass "
            "--frames with the rendered.npz that --render-only writes on "
            "a host with mujoco and h5py")
    os.makedirs(out, exist_ok=True)
    states = os.path.join(out, "states.hdf5")
    rendered = os.path.join(out, f"{name}.hdf5")
    npz = os.path.join(out, f"{name}.npz")
    if not os.path.exists(states):
        # cube_spin 0.10 rad/step (~6 deg/frame): fast enough that the
        # K-step lookahead rotation is material, slow enough that a
        # 3-frame window can estimate the rate
        playback.write_flagship_states_fixture(
            states, n_demos=demos, steps=demo_steps, seed=42,
            cube_spin=0.10)
        print(json.dumps({"states": states}), flush=True)
    if not os.path.exists(rendered):
        s = playback.render_playback_dataset(
            states, rendered, cameras=CAMERAS, image_hw=image_hw,
            target_body="cube")
        print(json.dumps({name: s}), flush=True)
    if not os.path.exists(npz):
        save_demos_npz(npz, *demo_file_arrays(rendered))
        print(json.dumps({"frames": npz}), flush=True)
    return npz


def load_frames(args: argparse.Namespace) -> Tuple[List[Dict], Dict]:
    """The rendered demos and their data attributes: from ``--frames``
    (numpy alone), else rendered into ``--out`` first."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        load_demos_npz,
    )

    return load_demos_npz(args.frames or render_frames(
        args.out, args.demos, args.demo_steps, args.image_hw))


def fixtures_of(args: argparse.Namespace, demos: List[Dict], attrs: Dict
                ) -> Dict[str, List[Dict]]:
    """The rows' two datasets: the rendered demos (current pose) and
    their lookahead relabeling, by the names their data.path takes."""
    return {"rendered": demos,
            f"rendered_la{args.lookahead}":
                derive_lookahead(demos, attrs, args.lookahead)[0]}


def standin_demos(n_demos: int, steps: int, image_hw: int, seed: int = 0
                  ) -> Tuple[List[Dict], Dict]:
    """Demos of the rendered file's keys, shapes and dtypes drawn without
    MuJoCo: write_demo_fixture's two occluded cameras with a velocity
    label (``demo_fixture_arrays``, camera_occlusion 0.12, velocity_alpha
    3), its 8-dim proprio split into obs/qpos and obs/qvel (4 each) and
    the label's first 7 columns as obs/object. The proprio correlates
    with the pose without copying it (proprio_pose_noise 0.05, the
    accuracy battery's "noisy" fixture), as the servoing arm's joint
    state does in the flagship scene: a random-walk proprio, unique per
    demo, is memorized instead. A check of the training and scoring half
    where nothing renders; not the flagship scene."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        demo_fixture_arrays,
    )

    demos = []
    for d in demo_fixture_arrays(n_demos=n_demos, steps=steps,
                                 cameras=CAMERAS, image_hw=image_hw,
                                 proprio_dim=8, seed=seed,
                                 proprio_pose_noise=0.05,
                                 camera_occlusion=0.12, velocity_alpha=3.0):
        ds = d["datasets"]
        proprio = ds["obs/robot0_proprio-state"]
        datasets = {f"obs/{c}_image": ds[f"obs/{c}_image"] for c in CAMERAS}
        datasets["obs/qpos"] = proprio[:, :4].copy()
        datasets["obs/qvel"] = proprio[:, 4:].copy()
        datasets["obs/object"] = ds["obs/object"][:, :7].copy()
        demos.append({"name": d["name"], "datasets": datasets,
                      "attrs": dict(d["attrs"])})
    return demos, {"env": "flagship_standin", "rendered_by": "none"}


def row_config(args: argparse.Namespace, name: str, ckpt_dir: str):
    """(cfg, eval_drop) of row ``name``: preset pr5 with the reference's
    battery settings and the row's overrides; data.path names the row's
    in-memory dataset (fixtures_of)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch import preset

    over = dict(ROWS[name])
    data_path = (f"rendered_la{args.lookahead}"
                 if over.pop("_data", "la") == "la" else "rendered")
    eval_drop = over.pop("_eval_drop", ())
    cfg = preset("pr5").override(**{
        "dist.num_devices": 1,
        "data.path": data_path,
        "data.proprio_key": "obs/qpos,obs/qvel",
        "data.target_key": "obs/object",
        "model.proprio_dim": 8,
        "model.image_size": args.image_hw,
        "data.batch_size": args.batch,
        "data.val_fraction": 0.2,
        "data.augment_device": True,
        "data.crop_margin": 4,
        "data.device_cache": True,
        "train.steps": args.steps,
        "train.steps_per_call": 1,
        "train.lr": 3e-4,
        "train.lr_schedule": "cosine",
        "train.warmup_steps": 100,
        "train.eval_every": 500,
        "train.eval_steps": 0,
        "train.ckpt_every": 0,
        "train.ckpt_best_metric": "pos_mae_cm",
        "train.ckpt_dir": ckpt_dir,
        "train.log_every": 250,
        **over,
    })
    return cfg, eval_drop


def ckpt_dir_of(out: str, name: str, prefix: str = "") -> str:
    """The reference's checkpoint directory of row ``name``."""
    return os.path.join(out, prefix + name.replace(" ", "_").replace(
        "(", "").replace(")", ""))


def run_row(args: argparse.Namespace, name: str,
            fixtures: Dict[str, List[Dict]], device) -> Dict[str, Any]:
    """Train row ``name`` on ``device`` and score its best checkpoint,
    with each ``_eval_drop`` camera dead. Returns {"results": {key: entry
    in the reference's format}, "seconds", "cfg", "fixtures"}."""
    acc = accuracy_script()
    ckpt_dir = ckpt_dir_of(args.out, name)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, eval_drop = row_config(args, name, ckpt_dir)
    out = acc.train_and_score(cfg, fixtures, eval_drop, device)
    m = out["metrics"]
    results = {name: {"pos_mae_cm": round(m["pos_mae_cm"], 2),
                      "rot_mae_deg": round(m["rot_mae_deg"], 2),
                      "steps": args.steps,
                      "held_out_demos": int(len(fixtures["rendered"]) * 0.2)}}
    print(json.dumps({name: results[name]}), flush=True)
    for cams, r in out["dead"].items():
        key = f"{name} [dead {cams}]"
        results[key] = {"pos_mae_cm": round(r["pos_mae_cm"], 2),
                        "rot_mae_deg": round(r["rot_mae_deg"], 2)}
        print(json.dumps({key: results[key]}), flush=True)
    return {"results": results, "seconds": out["seconds"], "cfg": cfg,
            "fixtures": {cfg.data.path: fixtures[cfg.data.path]}}


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the rows ``args.rows`` names (all when empty) on the rendered
    demos, accumulating results.json in ``args.out``; returns it."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.api import resolve_device

    device = resolve_device(args.device)     # no CPU fallback
    want = ([r.strip() for r in args.rows.split(",") if r.strip()]
            if args.rows else list(ROWS))
    unknown = [r for r in want if r not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {list(ROWS)}")
    demos, attrs = load_frames(args)
    if len(demos) != args.demos:
        print(json.dumps({"note": f"the frames hold {len(demos)} demos "
                                  f"(--demos {args.demos} ignored)"}),
              flush=True)
    fixtures = fixtures_of(args, demos, attrs)
    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for name in want:
        results.update(run_row(args, name, fixtures, device)["results"])
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.render_only:
        out = {"frames": render_frames(args.out, args.demos, args.demo_steps,
                                       args.image_hw)}
        print(json.dumps(out))
        return out
    return run(args)


if __name__ == "__main__":
    main()
