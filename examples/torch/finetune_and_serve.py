#!/usr/bin/env python
"""Finetune a frozen pretrained backbone, export, and serve, with the
PyTorch/CUDA port.

The production workflow a robot stack would actually run:

  1. import torchvision ResNet-18 weights into the image encoder
     (``train.init_from_torch``, through ``utils/torch_import.py``; here a
     seeded stand-in with torchvision's names and shapes, written as an
     ``.npz``, takes the place of a downloaded ``resnet18`` state_dict),
  2. freeze the backbone (model.freeze_backbone) and train only the
     fusion head + proprio branch on the demo set,
  3. export the result as a self-contained ``torch.export`` artifact
     (int8 weight-only quantized),
  4. serve it frame-by-frame behind an ObsBuffer (temporal stacking at
     the robot control loop).

Self-contained (generates a tiny demo file); runs on a CUDA card, or on
the CPU with ``--device cpu``.

    python examples/torch/finetune_and_serve.py [--steps 150] [--device cuda]
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
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
    export_predictor,
    load_predictor,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.obs_buffer import (
    ObsBuffer,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import import (
    import_torch_resnet,
)


def torchvision_resnet18_standin(seed=0):
    """A state_dict with torchvision resnet18's names and shapes (numpy,
    He-scaled normal convolutions, unit BatchNorms), standing in for
    ``torchvision.models.resnet18(weights=...).state_dict()``."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rs.randn(cout, cin, k, k)
                                * np.sqrt(2.0 / (cin * k * k))
                                ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (1 + 0.1 * rs.rand(c)).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(0, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, cout in enumerate((64, 128, 256, 512), start=1):
        for block in range(2):
            p = f"layer{layer}.{block}"
            conv(f"{p}.conv1", cout, cin if block == 0 else cout, 3)
            bn(f"{p}.bn1", cout)
            conv(f"{p}.conv2", cout, cout, 3)
            bn(f"{p}.bn2", cout)
            if block == 0 and cin != cout:
                conv(f"{p}.downsample.0", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
        cin = cout
    sd["fc.weight"] = (0.01 * rs.randn(1000, 512)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args()

    workdir = tempfile.mkdtemp(prefix="rppt_finetune_")
    demo_path = os.path.join(workdir, "demo.hdf5")
    write_demo_fixture(demo_path, n_demos=4, steps=25,
                       cameras=("agentview",), image_hw=84, proprio_dim=16)

    # 1. the pretrained backbone (with a real checkpoint: save
    #    torchvision.models.resnet18(weights=...).state_dict() with
    #    torch.save, or as an .npz of its keys, and point
    #    train.init_from_torch at the file)
    pretrained = os.path.join(workdir, "resnet18.npz")
    standin = torchvision_resnet18_standin()
    np.savez(pretrained, **standin)

    # finetune config: frozen ResNet-18 encoder, small head, temporal
    # buffer depth 1
    cfg = rppt.preset("pr2").override(**{
        "model.backbone": "resnet18",
        "model.use_proprio": True,
        "model.proprio_dim": 16,
        "model.image_size": 64,
        "model.image_features": 64,
        "model.head_hidden": [64],
        "model.freeze_backbone": True,
        "data.path": demo_path,
        "data.batch_size": 16,
        "data.val_fraction": 0.25,
        "train.steps": args.steps,
        "train.optimizer": "adamw",
        "train.weight_decay": 1e-4,
        "train.init_from_torch": pretrained,
        "train.log_every": max(args.steps // 3, 1),
        "train.eval_every": args.steps,
        "train.eval_steps": 2,
        "train.ckpt_every": args.steps,
        "train.ckpt_dir": os.path.join(workdir, "ckpt"),
    })
    # (To warm start from a checkpoint trained by THIS framework instead,
    # set train.init_from="<that run's ckpt_dir>": serving weights + BN
    # stats load, optimizer/step start fresh.)
    out = rppt.train(cfg, device=args.device)
    print("finetune metrics:", {k: round(float(v), 4)
                                for k, v in out["metrics"].items()
                                if k.startswith(("loss", "eval_pos"))})

    # 2. frozen means frozen: the encoder's weights are the imported ones,
    #    bit for bit; only head/proprio moved
    _, trained = checkpoint.load(out["ckpt_path"])
    imported = import_torch_resnet(standin, "resnet18")
    moved = [k for k, v in imported.items()
             if not k.endswith(("running_mean", "running_var"))
             and not np.array_equal(trained[f"encoder_agentview.{k}"]
                                    .numpy(), v)]
    print(f"encoder weights imported from {os.path.basename(pretrained)} "
          f"and unchanged by training: {not moved}")
    if moved:
        raise SystemExit(f"frozen encoder weights moved: {moved[:3]}")

    # 3. export: int8 weight-only artifact
    art = os.path.join(workdir, "pose.rppe")
    export_predictor(art, cfg, ckpt_dir=cfg.train.ckpt_dir, max_batch=4,
                     quantize="int8")
    serve = load_predictor(art, device=args.device)
    print(f"exported int8 artifact -> {art} "
          f"({os.path.getsize(art) / 1e6:.1f} MB)")

    # 4. robot control loop: one frame at a time through the ObsBuffer
    buf = ObsBuffer(cfg.model)
    rs = np.random.RandomState(0)
    for step in range(3):
        frame = {
            "images": {"agentview": rs.randint(
                0, 256, (cfg.model.image_size, cfg.model.image_size, 3),
                np.uint8)},
            "proprio": rs.randn(cfg.model.proprio_dim).astype(np.float32),
        }
        obs = buf.push(frame)
        batched = {
            "images": {c: v[None] for c, v in obs["images"].items()},
            "proprio": obs["proprio"][None],
        }
        pos, quat = serve(batched)
        print(f"step {step}: pos={np.round(pos[0], 3)} "
              f"quat={np.round(quat[0], 3)}")


if __name__ == "__main__":
    main()
