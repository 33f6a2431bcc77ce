#!/usr/bin/env python
"""End-to-end walkthrough with the PyTorch/CUDA port: data -> train ->
evaluate -> predict -> export.

Self-contained (generates a tiny demo file); runs on a CUDA card, or on
the CPU with ``--device cpu`` (the kernels' plain versions).

    python examples/torch/end_to_end.py [--steps 150] [--device cuda]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer import (
    ObsBuffer,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args()

    workdir = tempfile.mkdtemp(prefix="rppt_example_")
    demo_path = os.path.join(workdir, "demo.hdf5")

    # 1. data: a small robosuite-layout demo file (real robot stacks point
    #    cfg.data.path at their collected demo.hdf5 instead)
    write_demo_fixture(demo_path, n_demos=4, steps=25,
                       cameras=("agentview",), image_hw=84, proprio_dim=16)
    print(f"wrote demos -> {demo_path}")

    # 2. train: small CNN, RGB + proprio fusion, held-out demo for eval
    cfg = rppt.preset("pr2").override(**{
        "model.use_proprio": True,
        "model.proprio_dim": 16,
        "model.image_size": 64,
        "model.image_features": 64,
        "model.head_hidden": [64],
        "data.path": demo_path,
        "data.batch_size": 16,
        "data.val_fraction": 0.25,
        "data.hflip_prob": 0.0,        # flips would break image->pose geometry
        "train.steps": args.steps,
        "train.lr": 3e-3,
        "train.log_every": 50,
        "train.eval_every": args.steps,
        "train.ckpt_every": args.steps,
        "train.ckpt_dir": os.path.join(workdir, "ckpt"),
    })
    out = rppt.train(cfg, device=args.device)
    print("train metrics:", {k: round(v, 4) for k, v in out["metrics"].items()
                             if not k.startswith("eval_")})

    # 3. evaluate: restores the checkpoint, reports cm / deg MAE on the
    #    held-out demo
    metrics = rppt.evaluate(cfg, device=args.device)
    print(f"held-out: {metrics['pos_mae_cm']:.2f} cm, "
          f"{metrics['rot_mae_deg']:.2f} deg @ step {metrics['step']}")

    # 4. predict: online, one observation per control tick, with the
    #    temporal buffer (no-op here since temporal_frames=1)
    pred = rppt.Predictor(cfg, device=args.device)
    buf = ObsBuffer(cfg.model)
    rs = np.random.RandomState(0)
    obs = {
        "images": {"agentview": rs.randint(0, 256, (64, 64, 3), np.uint8)},
        "proprio": rs.randn(16).astype(np.float32),
    }
    pos, quat = pred(buf.push(obs))
    print("predicted pose:", np.round(pos, 3), np.round(quat, 3))

    # 5. export for serving: one self-contained torch.export artifact
    #    (the kernels stay in it as the ops rppe::normalize_u8 and
    #    rppe::scale_bias_relu)
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
        export_predictor,
        load_predictor,
    )

    artifact = export_predictor(os.path.join(workdir, "pose.rppe"), cfg,
                                max_batch=4)
    serve = load_predictor(artifact, device=args.device)
    batch = {k: (np.asarray(v)[None] if not isinstance(v, dict)
                 else {c: np.asarray(i)[None] for c, i in v.items()})
             for k, v in obs.items()}
    spos, squat = serve(batch)
    matches = bool(np.allclose(spos[0], pos, atol=1e-5))
    print(f"served from {os.path.basename(artifact)}:",
          np.round(spos[0], 3), "(matches:", matches, ")")
    if not matches:
        raise SystemExit("the artifact's pose differs from the Predictor's")


if __name__ == "__main__":
    main()
