#!/usr/bin/env python
"""Predictive pose estimation (preset pr5la) with the PyTorch/CUDA port:
train the flagship model to answer "where will the object be K steps
from now".

A pose used for grasping a MOVING object is stale by the time the gripper
arrives; the robotically-useful target is the pose at t+K. That label is
single-frame-ambiguous — per-episode velocity is invisible in one image —
so this is the config where pr5's temporal LSTM earns its keep, and the
`data.target_lookahead` knob makes the (obs@t, pose@t+K) pairing a config
flag instead of a dataset-preparation step.

This script runs the configuration of the K=6 composition row of the
flagship battery (docs/DESIGN.md "Full-composition battery", K=6
supplement; that row's numbers were measured with the JAX package):

  1. write the flagship playback scene (4-dof servoing arm, wrist +
     occluded agentview cameras, constant-velocity spinning cube)
  2. render it through headless MuJoCo (`cli render` path)
  3. train preset("pr5la") — pr5 + target_lookahead=6 — on the rendered
     file; evaluate held-out demos on the PREDICTED pose

Defaults are sized for a quick demonstration; --full matches the battery
row's scale (240 demos, 5000 steps, batch 128 — budget a few hours of
render + a CUDA card).

Requires headless GL (EGL; software mesa works), MuJoCo and h5py; the
render runs in a child process that imports no torch. Trains on a CUDA
card, or on the CPU with ``--device cpu``. Run:
  python examples/torch/predictive_pose.py [--steps 600] [--full] [--device cuda]
"""

# runnable from the repo root without PYTHONPATH
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import argparse
import json
import os
import tempfile

import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback import (
    render_playback_dataset,
    write_flagship_states_fixture,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--demos", type=int, default=12)
    ap.add_argument("--demo-steps", type=int, default=30)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-hw", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="battery-row scale: 240 demos x 50 steps, "
                         "128x128, batch 128, 5000 steps")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args()
    if args.full:
        args.demos, args.demo_steps = 240, 50
        args.steps, args.batch, args.image_hw = 5000, 128, 128
    work = args.out or tempfile.mkdtemp(prefix="rppt_predictive_")
    os.makedirs(work, exist_ok=True)

    # 1. the flagship scene (replace with your own states-only demo file);
    #    cube_spin 0.10 rad/step keeps the K-step rotation offset material
    states = write_flagship_states_fixture(
        os.path.join(work, "states.hdf5"), n_demos=args.demos,
        steps=args.demo_steps, seed=42, cube_spin=0.10)

    # 2. replay + render both cameras (cli equivalent: cli render
    #    --src states.hdf5 --out rendered.hdf5 --target-body cube)
    rendered = os.path.join(work, "rendered.hdf5")
    summary = render_playback_dataset(
        states, rendered, cameras=("agentview", "robot0_eye_in_hand"),
        image_hw=args.image_hw, target_body="cube")
    print(json.dumps({"rendered": summary}))

    # 3. train the predictive preset: pr5 + data.target_lookahead=6. The
    #    store pairs obs@t with pose@t+6 inside each demo (the last 6
    #    steps carry no sample); images and proprio are untouched.
    cfg = rppt.preset("pr5la").override(**{
        "dist.num_devices": 1,
        "data.path": rendered,
        "data.proprio_key": "obs/qpos,obs/qvel",
        "data.target_key": "obs/object",
        "model.proprio_dim": 8,
        "model.image_size": args.image_hw,
        "data.batch_size": args.batch,
        "data.val_fraction": 0.2,          # held out at demo granularity
        "data.augment_device": True,
        "data.crop_margin": 4,
        "data.device_cache": True,
        "train.steps": args.steps,
        "train.steps_per_call": 1,
        "train.lr": 3e-4,
        "train.lr_schedule": "cosine",
        "train.warmup_steps": min(100, args.steps // 4),
        "train.eval_every": max(args.steps // 10, 1),
        "train.eval_steps": 0,
        "train.ckpt_every": 0,
        "train.ckpt_best_metric": "pos_mae_cm",
        "train.ckpt_dir": os.path.join(work, "ckpt"),
        "train.log_every": max(args.steps // 10, 1),
        # battery-row serving path: EMA weights + BN recalibration
        "train.ema_decay": 0.999,
        "train.ema_bn_recal_batches": 30,
        "data.cache_layout": "sharded",
    })
    rppt.train(cfg, device=args.device)

    # 4. score the best checkpoint on held-out demos: the metric is MAE of
    #    the PREDICTED (t+6) pose
    best = rppt.evaluate(cfg.override(**{
        "train.ckpt_dir": os.path.join(work, "ckpt", "best")}), split="val",
        device=args.device)
    print(json.dumps({"predictive_pose_mae": {
        "pos_mae_cm": round(best["pos_mae_cm"], 2),
        "rot_mae_deg": round(best["rot_mae_deg"], 2),
        "lookahead": cfg.data.target_lookahead,
    }}))


if __name__ == "__main__":
    main()
