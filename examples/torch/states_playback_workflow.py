#!/usr/bin/env python
"""States-only demos → trained pose estimator, end to end, with the
PyTorch/CUDA port.

The robosuite demonstration collector writes demos WITHOUT rendered
observations (per-demo MuJoCo `states` + the MJCF in a `model_file`
attr). This is the complete workflow from such a file to a serving
predictor:

  1. (stand-in for your data) write a tiny self-contained states fixture
  2. `render_playback_dataset` — replay the states through headless
     MuJoCo, render the cameras, extract the target body's pose, and
     materialize a robomimic-layout file (the `cli render` command)
  3. train on the rendered file through the unchanged pipeline
     (multi-key proprio `obs/qpos,obs/qvel`, target `obs/object`)
  4. evaluate + predict on one rendered frame

Requires headless GL (EGL; software mesa works), MuJoCo and h5py; the
render runs in a child process that imports no torch. Trains on a CUDA
card, or on the CPU with ``--device cpu``. Run:
  python examples/torch/states_playback_workflow.py [--steps 400] [--device cuda]
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

import numpy as np

import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback import (
    render_playback_dataset,
    write_states_fixture,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args()
    work = args.out or tempfile.mkdtemp(prefix="rppt_playback_")
    os.makedirs(work, exist_ok=True)

    # 1. a states-only demo file (replace with your robosuite demo.hdf5)
    src = write_states_fixture(os.path.join(work, "states.hdf5"),
                               n_demos=4, steps=25)

    # 2. replay + render (cli equivalent:
    #    cli render --src states.hdf5 --out rendered.hdf5
    #        --target-body cube --set model.image_size=64)
    rendered = os.path.join(work, "rendered.hdf5")
    summary = render_playback_dataset(src, rendered,
                                      cameras=("agentview",),
                                      image_hw=64, target_body="cube")
    print(json.dumps({"rendered": summary}))

    # 3. train on the rendered file — standard pipeline, nothing special
    cfg = rppt.preset("pr2").override(**{
        "model.backbone": "cnn_small",
        "model.image_size": 64,
        "model.image_features": 48,
        "model.head_hidden": (48,),
        "model.proprio_dim": 4,              # qpos(2) + qvel(2)
        "model.proprio_hidden": (16,),
        "model.proprio_features": 8,
        "data.path": rendered,
        "data.proprio_key": "obs/qpos,obs/qvel",
        "data.target_key": "obs/object",
        "data.batch_size": 16,
        "data.num_workers": 0,
        "data.jitter_prob": 0.0,
        "train.steps": args.steps,
        "train.lr": 3e-3,
        "train.eval_every": args.steps,
        "train.eval_steps": 2,
        "train.ckpt_every": args.steps,
        "train.log_every": max(args.steps // 4, 1),
        "train.ckpt_dir": os.path.join(work, "ckpt"),
    })
    out = rppt.train(cfg, device=args.device)
    print(json.dumps({k: round(float(v), 4)
                      for k, v in out["metrics"].items()}))

    # 4. predict the pose of one rendered frame
    import h5py

    with h5py.File(rendered) as f:
        g = f["data/demo_0/obs"]
        obs = {"images": {"agentview": g["agentview_image"][0]},
               "proprio": np.concatenate([g["qpos"][0], g["qvel"][0]]
                                         ).astype(np.float32)}
        truth = g["object"][0]
    pred = rppt.Predictor(cfg, max_batch=1, device=args.device).warmup()
    pos, quat = pred(obs)
    print(json.dumps({
        "pred_pos": [round(float(v), 3) for v in pos],
        "true_pos": [round(float(v), 3) for v in truth[:3]],
        "pos_err_cm": round(float(np.linalg.norm(pos - truth[:3])) * 100, 2),
    }))


if __name__ == "__main__":
    main()
