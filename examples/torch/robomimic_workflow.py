#!/usr/bin/env python
"""A robomimic-style research workflow, end to end, with the PyTorch/CUDA
port.

Exercises the data-side parity features a robomimic user reaches for
first (docs/MIGRATION.md), all in one run:

  1. several demo HDF5 files loaded at once (`data.path` glob / comma
     list -- demos concatenate, per-demo names file-qualified),
  2. a `mask/<filter_key>` demo subset (`data.filter_key`),
  3. a data-efficiency cap (`data.max_demos`),
  4. EMA weight averaging with BN recalibration for the serving weights
     (`train.ema_decay` + `train.ema_bn_recal_batches` -- the
     swa_utils.update_bn recipe; see docs/DESIGN.md "EMA weight
     averaging"),
  5. early stopping on the held-out metric
     (`train.early_stop_patience`),
  6. per-trajectory evaluation (`evaluate(per_demo=True)`) to find which
     demos the model fails on,
  7. adapting to a NEW task by warm-starting from the finished run
     (`train.init_from`: serving weights + BN stats load; optimizer,
     step, and data order start fresh).

Self-contained (generates two tiny demo files); runs on a CUDA card, or
on the CPU with ``--device cpu``.

    python examples/torch/robomimic_workflow.py [--steps 300] [--device cuda]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
    write_demo_fixture,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args()

    work = tempfile.mkdtemp(prefix="rppt_robomimic_")
    # two "task" files; lift.hdf5 carries a robomimic-style filter key
    # naming a 3-demo subset
    write_demo_fixture(os.path.join(work, "lift.hdf5"), n_demos=4,
                       steps=30, image_hw=84, seed=1,
                       filter_keys={"good_demos": [0, 1, 3]})
    write_demo_fixture(os.path.join(work, "can.hdf5"), n_demos=3,
                       steps=30, image_hw=84, seed=2,
                       filter_keys={"good_demos": [0, 2]})

    cfg = rppt.preset("pr2").override(**{
        "data.path": os.path.join(work, "*.hdf5"),   # both files
        "data.filter_key": "good_demos",             # 3 + 2 demos survive
        "data.max_demos": 4,                         # data-efficiency cap
        "data.val_fraction": 0.25,                   # 1 held-out demo
        "data.batch_size": 16,
        "model.image_size": 64,
        "model.image_features": 64,
        "model.head_hidden": (64,),
        "train.steps": args.steps,
        "train.eval_every": 50,
        "train.eval_steps": 0,                       # full held-out split
        "train.early_stop_patience": 3,
        "train.ema_decay": 0.99,
        "train.ema_bn_recal_batches": 8,
        "train.ckpt_every": 0,
        "train.log_every": 50,
        "train.ckpt_dir": os.path.join(work, "ckpt"),
    })

    out = rppt.train(cfg, device=args.device)
    m = out["metrics"]
    print(json.dumps({k: round(float(v), 4) for k, v in m.items()},
                     indent=2))
    if "early_stopped_at" in m:
        print(f"early-stopped at step {int(m['early_stopped_at'])}")

    rows = rppt.evaluate(cfg, per_demo=True,
                         success_at=[(2.0, 10.0), (5.0, 30.0)],
                         dump_predictions=os.path.join(work, "preds.npz"),
                         device=args.device)
    print("per-demo held-out breakdown (file-qualified names):")
    for name, r in rows["per_demo"].items():
        print(f"  {name}: {r['pos_mae_cm']:.1f} cm / "
              f"{r['rot_mae_deg']:.1f} deg over {r['steps']} steps")
    for s in rows["success"]:
        print(f"  success @ {s['pos_cm']:g} cm & {s['rot_deg']:g} deg: "
              f"{100 * s['rate']:.0f}% (pos {100 * s['pos_rate']:.0f}% / "
              f"rot {100 * s['rot_rate']:.0f}%)")
    print(f"per-sample predictions: {rows['predictions_path']}")

    # 7. a new task appears: warm-start from the run above instead of
    #    training from scratch (the torch load_state_dict-then-train
    #    recipe; docs/MIGRATION.md "warm start")
    write_demo_fixture(os.path.join(work, "square.hdf5"), n_demos=3,
                       steps=30, image_hw=84, seed=3)
    ft = rppt.train(cfg.override(**{
        "data.path": os.path.join(work, "square.hdf5"),
        "data.filter_key": "",
        "data.max_demos": 0,
        "train.init_from": os.path.join(work, "ckpt"),
        "train.ckpt_dir": os.path.join(work, "ckpt_ft"),
        "train.steps": max(args.steps // 3, 10),
        "train.log_every": 10,
        "train.eval_every": 0,
        "train.eval_steps": 16,
        "train.early_stop_patience": 0,
    }), device=args.device)
    print(f"warm-started finetune on the new task: final loss "
          f"{float(ft['metrics']['loss']):.4f} at step "
          f"{int(ft['state'].step)}")


if __name__ == "__main__":
    main()
