#!/usr/bin/env python3
"""The rotation root-cause grid of the PyTorch/CUDA port: the rows of the
JAX package's ``scripts/flagship_rot_diag.py`` on the rendered flagship
scene, each isolating one candidate cause of the scene's rotation MAE at
K=0 (current-pose labels) with a single-frame model: the crop
augmentation, the rotation head (quat or rot6d), the resolution (a
64 px down-probe on the 128 px frames; a 224 px up-probe on a render of
its own), and the camera. Rows share the flagship battery's methodology
(``scripts/torch_flagship_battery.py``: 20% of the demos held out, the
best checkpoint on held-out pos MAE, device cache and device
augmentation where augmentation is on).

The demos are the battery's: its states and 128 px render (the same
files in ``--out``, so a battery's ``--out`` is reused), carried to the
card as ``.npz`` arrays:

    # where mujoco and EGL are (--render224 adds rendered224.npz)
    python3 scripts/torch_flagship_rot_diag.py --render-only --out DIR
    # on the card
    python3 scripts/torch_flagship_rot_diag.py --frames DIR/rendered.npz \\
        [--frames224 DIR/rendered224.npz] [--steps 5000] [--out DIR2] \\
        [--rows "diag base (aug-on quat)"]

Without ``--frames`` it renders into ``--out`` first where ``mujoco`` and
``h5py`` are, and raises naming both them and ``--frames`` where they are
not. The held-out demo count is read from the arrays. ``rot_diag.json``
in ``--out`` accumulates the rows in the reference's keys and rounding
(``docs/artifacts/flagship_rot_diag_r5.json``). ``--device cpu`` exists
for the tests.
"""

from __future__ import annotations

# runnable as python3 scripts/torch_flagship_rot_diag.py from the repo root
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
from typing import Any, Dict, Optional, Sequence

# single-frame, K=0 (labels at t): the floor regime where rotation is
# directly observable in the frame -- every factor isolated from temporal
# effects. EMA/recal kept (serving path, orthogonal to rotation).
# (the reference's BASE, AUG_OFF and ROWS, as is)
BASE = {
    "model.temporal_frames": 1,
    "train.ema_decay": 0.999,
    "train.ema_bn_recal_batches": 30,
    "data.cache_layout": "sharded",
}
AUG_OFF = {
    "data.augment": False,
    "data.augment_device": False,
    "data.crop_margin": 0,
}

# row names avoid commas: --rows splits on them
ROWS = {
    "diag base (aug-on quat)": {**BASE},
    "diag aug-off (quat)": {**BASE, **AUG_OFF},
    "diag rot6d (aug on)": {**BASE, "model.rot_rep": "rot6d"},
    "diag aug-off rot6d": {**BASE, **AUG_OFF, "model.rot_rep": "rot6d"},
    # resolution DOWN-probe: same stored 128px frames, model at 64
    "diag lowres-64 (aug-on quat)": {**BASE, "model.image_size": 64},
    # per-camera orientation observability (aug off so the answer is not
    # confounded by the crop factor)
    "diag agentview-only (aug off)": {
        **BASE, **AUG_OFF, "model.cameras": ("agentview",)},
    "diag wrist-only (aug off)": {
        **BASE, **AUG_OFF, "model.cameras": ("robot0_eye_in_hand",)},
    # UP-probe rows (need --render224; trains on a fresh 224px render)
    "diag 224 (aug-on quat)": {**BASE, "_data": "rendered224",
                                "model.image_size": 224},
    "diag 224 aug-off (quat)": {**BASE, **AUG_OFF, "_data": "rendered224",
                                "model.image_size": 224},
    # seed replicas: error bars for the base-vs-rot6d delta (same split,
    # different init/training randomness)
    "diag base seed1": {**BASE, "train.seed": 1},
    "diag rot6d seed1": {**BASE, "model.rot_rep": "rot6d",
                         "train.seed": 1},
}


def _battery():
    """scripts/torch_flagship_battery.py, whose render, arrays and
    training this grid shares."""
    spec = importlib.util.spec_from_file_location(
        "torch_flagship_battery",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_flagship_battery.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demos", type=int, default=240)
    ap.add_argument("--demo-steps", type=int, default=50)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rppe_flag6"),
                    help="pass the battery's --out so its states and 128px "
                         "render are reused; a reused states file overrides "
                         "--demos/--demo-steps (the count is read back from "
                         "the arrays and recorded)")
    ap.add_argument("--rows", default="",
                    help="comma-separated subset of rows to run")
    ap.add_argument("--render224", action="store_true",
                    help="also render the scene at 224px (expensive) and "
                         "enable the 224 rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu is for the tests")
    ap.add_argument("--render-only", action="store_true",
                    help="write states.hdf5, rendered.hdf5/.npz (and with "
                         "--render224 rendered224.hdf5/.npz) into --out "
                         "and stop (needs mujoco, h5py)")
    ap.add_argument("--frames", default="",
                    help="the 128px rendered demos' .npz (--render-only's)")
    ap.add_argument("--frames224", default="",
                    help="the 224px rendered demos' .npz; enables the 224 "
                         "rows")
    return ap.parse_args(argv)


def row_config(args: argparse.Namespace, name: str, ckpt_dir: str):
    """The config of row ``name``: preset pr5 with the reference's grid
    settings and the row's overrides; data.path names the row's
    in-memory dataset ("rendered" or "rendered224")."""
    from rgb_proprioceptive_pose_estimator_tpu_torch import preset

    over = dict(ROWS[name])
    data_path = over.pop("_data", "rendered")
    return preset("pr5").override(**{
        "dist.num_devices": 1,
        "data.path": data_path,
        "data.proprio_key": "obs/qpos,obs/qvel",
        "data.target_key": "obs/object",
        "model.proprio_dim": 8,
        "model.image_size": 128,
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


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the rows ``args.rows`` names (all when empty; the 224 rows
    only with 224px frames), accumulating rot_diag.json in
    ``args.out``; returns it."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.api import resolve_device
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        load_demos_npz,
    )

    flag = _battery()
    acc = flag.accuracy_script()
    device = resolve_device(args.device)     # no CPU fallback
    want = ([r.strip() for r in args.rows.split(",") if r.strip()]
            if args.rows else list(ROWS))
    unknown = [r for r in want if r not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {list(ROWS)}")
    with224 = bool(args.frames224) or args.render224
    want = [r for r in want
            if ROWS[r].get("_data") != "rendered224" or with224]
    fixtures = {"rendered": load_demos_npz(args.frames or flag.render_frames(
        args.out, args.demos, args.demo_steps, 128))[0]}
    if any(ROWS[r].get("_data") == "rendered224" for r in want):
        fixtures["rendered224"] = load_demos_npz(
            args.frames224 or flag.render_frames(
                args.out, args.demos, args.demo_steps, 224,
                "rendered224"))[0]
    # the demos actually trained on, whatever --demos says
    n_demos = len(fixtures["rendered"])
    if n_demos != args.demos:
        print(json.dumps({"note": f"the frames hold {n_demos} demos "
                                  f"(--demos {args.demos} ignored)"}),
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "rot_diag.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for name in want:
        ckpt_dir = flag.ckpt_dir_of(args.out, name, "diag_")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        cfg = row_config(args, name, ckpt_dir)
        m = acc.train_and_score(cfg, fixtures, (), device)["metrics"]
        results[name] = {"pos_mae_cm": round(m["pos_mae_cm"], 2),
                         "rot_mae_deg": round(m["rot_mae_deg"], 2),
                         "steps": args.steps,
                         "held_out_demos": int(n_demos * 0.2)}
        print(json.dumps({name: results[name]}), flush=True)
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.render_only:
        flag = _battery()
        out = {"frames": flag.render_frames(args.out, args.demos,
                                            args.demo_steps, 128)}
        if args.render224:
            out["frames224"] = flag.render_frames(
                args.out, args.demos, args.demo_steps, 224, "rendered224")
        print(json.dumps(out))
        return out
    return run(args)


if __name__ == "__main__":
    main()
