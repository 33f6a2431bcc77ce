#!/usr/bin/env python3
"""The accuracy battery of the PyTorch/CUDA port: the rows of the JAX
package's ``scripts/accuracy_artifact.py``, trained on a CUDA card to
convergence and scored on held-out demos.

Each row trains preset pr3 plus the battery's settings (device cache,
device augmentation, cosine LR, an eval every 500 steps, the best
checkpoint on held-out pos MAE) and the row's own overrides through
``engine.loop.train_on``, then scores the best checkpoint over the whole
held-out split with ``api.evaluate_on`` (and once more with each
``_eval_drop`` camera dead). The fixtures are ``write_demo_fixture``'s
demos built in memory (``data/hdf5_store.demo_fixture_arrays``, bit for
bit the file's) and read through the HDF5 store's own code
(``MemoryDemoStore``), so the battery needs no ``h5py``. The ``mjrender``
fixture is rendered with MuJoCo (``data/playback.py``) and travels as
arrays in one ``.npz`` that numpy alone reads: ``--render-only`` writes it
on a host with ``mujoco`` and ``h5py`` (``demos_mjrender.npz`` in
``--out``), and ``--frames`` hands it to the row on the card. Without
``--frames`` the row renders where it runs, which needs both modules.

    python3 scripts/torch_accuracy_artifact.py [--demos 40] [--steps 3000] \\
        [--out DIR] [--rows "image-only,dual-cam (occluded)"] [--seed 1]
    python3 scripts/torch_accuracy_artifact.py --render-only --out DIR
    python3 scripts/torch_accuracy_artifact.py --frames DIR/demos_mjrender.npz \\
        --rows "image+qpos (mujoco-rendered)"

``results.json`` in ``--out`` accumulates the rows in the reference's
format; ``runs.json`` beside it holds each row's wall-clock seconds, the
card (``nvidia-smi``'s name and power limit), dtype, TF32 setting and
train.seed. ``--seed N`` sets train.seed and keys the row "<row> (seedN)".

    python3 scripts/torch_accuracy_artifact.py --collect DIR [DIR ...] \\
        --artifact docs/artifacts/torch_accuracy_h100.json

merges the runs of several ``--out`` directories into one file beside the
reference's figures (JAX package, TPU v5e, accuracy only), with each
row's band and the five readings of docs/DESIGN.md.

``--device cpu`` exists for the tests; the battery runs on CUDA.
"""

from __future__ import annotations

# runnable as python3 scripts/torch_accuracy_artifact.py from the repo root
# without PYTHONPATH: the package lives one directory above this file
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# fixture name -> extra write_demo_fixture kwargs (the reference's, as is)
FIXTURES = {
    "plain": {},
    "noisy": {"proprio_pose_noise": 0.05},
    "occl": {"cameras": ("agentview", "robot0_eye_in_hand"),
             "camera_occlusion": 0.12},
    # alpha=3: the velocity term contributes ~7 cm to the single-frame
    # floor -- it must DOMINATE the temporal models' small-data
    # generalization penalty (~2-3 cm at 40 demos), or the comparison
    # measures regularization, not temporal capability (alpha=1 measured
    # exactly that: single-frame 11.98 vs temporal 12.5-14.1)
    "vel": {"velocity_alpha": 3.0},
    # correlated eef-pose-like proprio in ill-conditioned raw units
    # (per-dim scales 1e-2..1e3, informative dims :7 at the SMALL end):
    # the model.proprio_normalize rows
    "scaled": {"proprio_pose_noise": 0.05,
               "proprio_scale": tuple(np.logspace(-2.0, 3.0, 32))},
    # mislabeled-frame corruption (train.pos_loss="huber" justification):
    # 20% of TRAIN position labels replaced with uniform-random points
    # (images stay honest); scored against a CLEAN different-seed val
    # file so the metric measures robustness, not corrupted ground truth
    "outlier": {"label_outlier_frac": 0.2},
    "clean_val": {"seed": 99},
    # handled specially in fixture_path: a MuJoCo-RENDERED dataset via
    # the state-playback converter (data/playback.py) -- realistic
    # shading/perspective instead of drawn markers; certifies the
    # playback ingestion path at training scale
    "mjrender": {},
}

# row name -> config overrides (the reference's, as is); "_fixture",
# "_val_fixture" and "_eval_drop" are the battery's own keys
ROWS = {
    "image-only": {"model.use_proprio": False},
    "image+proprio": {},
    "image+proprio (dropout)": {"model.proprio_dropout": 0.5},
    # no images -> nothing to device-cache (build_dataset validates)
    "proprio-only (control)": {"model.backbone": "none",
                               "data.device_cache": False,
                               "data.augment_device": False},
    # realistic correlated proprio (eef-pose-like, sigma=0.05): fusion
    # should BEAT image-only here -- the case the architecture exists for
    # (the "_eval_drop" eval scores the CAMERA dead: without
    # camera_dropout training the zeroed image features are OOD even
    # though the proprio branch still carries the pose)
    "image+noisy-pose-proprio": {"_fixture": "noisy",
                                 "_eval_drop": ("agentview",)},
    # the all-sensors-degraded fallback: with camera_dropout the model
    # TRAINS the camera-dead case (with a proprio branch, all-cameras-
    # dead rows are kept as valid training samples, models/fusion.py),
    # so a dead camera should degrade toward the proprio-informed floor
    # instead of collapsing (name avoids a comma: --rows splits on them)
    "image+noisy-pose-proprio (cam-dropout)": {
        "_fixture": "noisy", "model.camera_dropout": 0.15,
        "_eval_drop": ("agentview",)},
    # informative-proprio case with the branch regularized: small-data
    # guidance row (does dropout preserve the fusion win too?)
    "image+noisy-pose-proprio (dropout)": {
        "_fixture": "noisy", "model.proprio_dropout": 0.5},
    # EMA weight averaging (train.ema_decay): same data/arch as the noisy
    # row; the best checkpoint + final evaluate() serve the EMA weights.
    # Measured both under the battery's cosine schedule (where annealing
    # already averages -- EMA expected ~neutral) and under constant LR
    # (EMA's classic win case: averaging replaces the anneal).
    "image+noisy-pose-proprio (ema)": {
        "_fixture": "noisy", "train.ema_decay": 0.999},
    "image+noisy-pose-proprio (const-lr)": {
        "_fixture": "noisy", "train.lr_schedule": "constant",
        "train.warmup_steps": 0},
    # (name avoids a comma: --rows splits on commas)
    "image+noisy-pose-proprio (const-lr ema)": {
        "_fixture": "noisy", "train.lr_schedule": "constant",
        "train.warmup_steps": 0, "train.ema_decay": 0.999},
    # + BN recalibration (train.ema_bn_recal_batches, the torch update_bn
    # recipe): the const-lr-ema row without it measures the EMA/BN
    # train-serve stats mismatch, not EMA itself
    "image+noisy-pose-proprio (const-lr ema recal)": {
        "_fixture": "noisy", "train.lr_schedule": "constant",
        "train.warmup_steps": 0, "train.ema_decay": 0.999,
        "train.ema_bn_recal_batches": 30},
    # --- model.rot_rep="rot6d": continuous rotation head vs raw quat ---
    # (same data/arch as image-only; the fixture's orientation walk covers
    # SO(3), so the quat head's antipodal double cover is exercised)
    "image-only (rot6d)": {"model.use_proprio": False,
                           "model.rot_rep": "rot6d"},
    # rot6d in the flagship FUSION config (correlated noisy-pose proprio):
    # guards the image-only win against an interaction regression
    "image+noisy-pose-proprio (rot6d)": {
        "_fixture": "noisy", "model.rot_rep": "rot6d"},
    # --- pr5: dual camera must help on per-camera-occluded data --------
    "single-cam (occluded)": {"_fixture": "occl",
                              "model.use_proprio": False},
    "dual-cam (occluded)": {
        "_fixture": "occl", "model.use_proprio": False,
        "model.cameras": ("agentview", "robot0_eye_in_hand"),
        "_eval_drop": ("agentview", "robot0_eye_in_hand")},
    # --- model.camera_dropout: sensor-failure robustness ----------------
    # same data/arch as dual-cam (occluded) plus train-time modality
    # dropout; the "_eval_drop" evals score each camera DEAD
    # (evaluate(drop_cameras=...)) -- without the dropout training the
    # zeroed-features input is out-of-distribution and should collapse,
    # with it the model should degrade toward the single-cam floor
    # (name avoids a comma: --rows splits on commas)
    "dual-cam (occluded cam-dropout)": {
        "_fixture": "occl", "model.use_proprio": False,
        "model.cameras": ("agentview", "robot0_eye_in_hand"),
        "model.camera_dropout": 0.15,
        "_eval_drop": ("agentview", "robot0_eye_in_hand")},
    # --- pr5: temporal stacking must help on velocity-labeled data -----
    # (augment off: inter-frame marker displacement IS the signal; a
    # per-frame random crop would corrupt it)
    "single-frame (velocity)": {
        "_fixture": "vel", "model.use_proprio": False,
        "data.augment": False, "data.augment_device": False,
        "data.crop_margin": 0},
    "temporal-channel (velocity)": {
        "_fixture": "vel", "model.use_proprio": False,
        "model.temporal_frames": 3, "model.temporal_mode": "channel",
        "data.augment": False, "data.augment_device": False,
        "data.crop_margin": 0},
    "temporal-lstm (velocity)": {
        "_fixture": "vel", "model.use_proprio": False,
        "model.temporal_frames": 3, "model.temporal_mode": "lstm",
        "data.augment": False, "data.augment_device": False,
        "data.crop_margin": 0},
    # --- model.proprio_normalize: raw mixed-unit proprio vs z-scored ---
    # (informative eef-pose dims sit at scale 1e-2 next to 1e3-scale
    # distractor dims; normalization must recover the fusion win the
    # "noisy" fixture shows at unit scale)
    "image+scaled-proprio (raw)": {"_fixture": "scaled"},
    "image+scaled-proprio (normalized)": {
        "_fixture": "scaled", "model.proprio_normalize": True},
    # --- train.pos_loss="huber" vs "mse" on 20%-mislabeled train data --
    # (clean held-out val file: the linear tails should cap the pull of
    # the bad labels; MSE fits them)
    "image-only (outlier-labels mse)": {
        "_fixture": "outlier", "_val_fixture": "clean_val",
        "model.use_proprio": False},
    "image-only (outlier-labels huber)": {
        "_fixture": "outlier", "_val_fixture": "clean_val",
        "model.use_proprio": False,
        "train.pos_loss": "huber", "train.huber_delta": 0.05},
    # delta between the inlier residual scale (~0.1 m held-out here) and
    # the outlier distance (~0.4 m): inliers keep their full quadratic
    # gradient, outliers are capped. delta=0.05 (above) puts even inliers
    # in the linear zone -- measured to undertrain at this step budget
    "image-only (outlier-labels huber d15)": {
        "_fixture": "outlier", "_val_fixture": "clean_val",
        "model.use_proprio": False,
        "train.pos_loss": "huber", "train.huber_delta": 0.15},
    # clean-train control: the no-corruption floor for the pair above
    "image-only (clean-labels mse)": {
        "_val_fixture": "clean_val", "model.use_proprio": False},
    # --- state-playback path: ResNet-18 on MuJoCo-rendered frames ------
    "image+qpos (mujoco-rendered)": {
        "_fixture": "mjrender",
        "model.proprio_dim": 4,
        "data.proprio_key": "obs/qpos,obs/qvel",
        "data.target_key": "obs/object"},
    # --- pr4: resnet50 @ 224 bf16 held-out MAE -------------------------
    "resnet50-224-bf16 (pr4)": {
        "model.backbone": "resnet50", "model.image_size": 224,
        "model.dtype": "bfloat16", "model.remat": True,
        "model.image_features": 1024},
    # the fair same-resolution comparator for the pr4 rung (VERDICT r3
    # next-1: does ResNet-50 EVER beat ResNet-18? run both at 224 on the
    # same data/steps; the r3 49.7-deg row had no r18@224 counterpart)
    "resnet18-224-bf16": {
        "model.image_size": 224, "model.dtype": "bfloat16"},
    # --- VERDICT r4 next-3: isolate the 224-resolution regression -------
    # (r18@224 measured ~4 cm / ~14 deg WORSE than the 128 rung at every
    # data scale tried). Same backbone + dtype + proprio at both
    # resolutions, aug on/off, plus the fixture's native 160: is the cost
    # the resolution rung itself, its interaction with the random-crop
    # aug, or the 160->224 upsample? (The stored fixture is 160 px: the
    # 128 rung downsamples, the 224 rung upsamples; crop is relatively
    # GENTLER at 224 -- 224/232 vs 128/136 of the frame.)
    "resnet18-128-bf16": {
        "model.image_size": 128, "model.dtype": "bfloat16"},
    "resnet18-160-bf16": {
        "model.image_size": 160, "model.dtype": "bfloat16"},
    "resnet18-128-bf16 (no-aug)": {
        "model.image_size": 128, "model.dtype": "bfloat16",
        "data.augment": False, "data.augment_device": False,
        "data.crop_margin": 0},
    "resnet18-224-bf16 (no-aug)": {
        "model.image_size": 224, "model.dtype": "bfloat16",
        "data.augment": False, "data.augment_device": False,
        "data.crop_margin": 0},
    # decomposition rows for the weak-2 confound: the r4 comparison
    # ("image-only @128 f32 = 8.71 cm" vs "r18 @224 bf16 + proprio =
    # 12.49 cm") moved THREE factors at once. These two rows isolate the
    # proprio-distractor branch from the resolution rung at equal dtype:
    "image-only-128-bf16": {
        "model.use_proprio": False,
        "model.image_size": 128, "model.dtype": "bfloat16"},
    "image-only-224-bf16": {
        "model.use_proprio": False,
        "model.image_size": 224, "model.dtype": "bfloat16"},
    # seed-variance replicas: same split (data.split_seed untouched),
    # different init/training randomness -- the error bars for the
    # resolution-grid deltas above
    "resnet18-128-bf16 (seed1)": {
        "model.image_size": 128, "model.dtype": "bfloat16",
        "train.seed": 1},
    "resnet18-128-bf16 (seed2)": {
        "model.image_size": 128, "model.dtype": "bfloat16",
        "train.seed": 2},
    "resnet18-224-bf16 (seed1)": {
        "model.image_size": 224, "model.dtype": "bfloat16",
        "train.seed": 1},
    # --- beyond-reference ViT backbone (models/vit.py): held-out MAE on
    # the same fixture as the ResNet-18 "image-only" row, so the two
    # backbones are directly comparable at equal data/steps
    "image-only (vit)": {"model.use_proprio": False,
                         "model.backbone": "vit"},
}

# Rows of the port's own. pr3 has set model.proprio_normalize since the
# reference measured its "(raw)" row (102.77 cm), so that row now trains
# normalized, as "(normalized)" does; this one is the configuration the
# reference's figure was measured with.
PORT_ROWS = {
    "image+scaled-proprio (raw normalize-off)": {
        "_fixture": "scaled", "model.proprio_normalize": False},
}

# The reference's held-out figures: the JAX package on a TPU v5e,
# accuracy only (docs/DESIGN.md:528-560): row -> (demos, steps, pos MAE
# cm, rot MAE deg). The port's (raw normalize-off) row is held to the
# "(raw)" figure, which was measured without normalization.
REFERENCE = {
    "image-only": (40, 3000, 8.84, 31.4),
    "image+proprio": (40, 3000, 15.45, 56.8),
    "image+proprio (dropout)": (40, 3000, 10.12, 34.3),
    "proprio-only (control)": (40, 3000, 42.7, 87.0),
    "image+noisy-pose-proprio": (40, 3000, 14.06, 22.61),
    "image+noisy-pose-proprio (dropout)": (40, 3000, 13.68, 21.6),
    "single-cam (occluded)": (40, 3000, 14.8, 37.1),
    "dual-cam (occluded)": (40, 3000, 12.05, 26.3),
    "image+scaled-proprio (raw)": (40, 3000, 102.77, 88.73),
    "image+scaled-proprio (normalized)": (40, 3000, 15.18, 28.5),
    "single-frame (velocity)": (120, 6000, 14.60, 17.4),
    "temporal-channel (velocity)": (120, 6000, 13.31, 20.1),
    "temporal-lstm (velocity)": (120, 6000, 11.52, 18.3),
    "resnet50-224-bf16 (pr4)": (40, 6000, 11.65, 49.7),
}
# a row meets the reference within max(2 cm, 15%) and max(8 deg, 15%)
BAND_POS_CM, BAND_ROT_DEG, BAND_REL = 2.0, 8.0, 0.15


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demos", type=int, default=40)
    ap.add_argument("--demo-steps", type=int, default=60)
    ap.add_argument("--image-hw", type=int, default=160)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rppe_acc"))
    ap.add_argument("--rows", default="",
                    help="comma-separated subset of rows to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu is for the tests")
    ap.add_argument("--seed", type=int, default=None,
                    help="train.seed; the row is keyed '<row> (seedN)'")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a config override after the row's, as the CLI's")
    ap.add_argument("--note", default="",
                    help="recorded with each run in runs.json, e.g. what "
                         "else shared the card")
    ap.add_argument("--render-only", action="store_true",
                    help="render the mjrender fixture into --out as "
                         "demos_mjrender.npz and stop (needs mujoco, h5py)")
    ap.add_argument("--frames", default="",
                    help="the mjrender fixture's .npz (--render-only's)")
    ap.add_argument("--collect", nargs="+", default=None, metavar="DIR",
                    help="merge these --out directories into --artifact")
    ap.add_argument("--artifact", default="",
                    help="the file --collect writes")
    return ap.parse_args(argv)


def render_mjrender(args: argparse.Namespace) -> str:
    """The mjrender fixture as the reference's fixture_path writes it
    (write_states_fixture seed 7, agentview at --image-hw, each file made
    only where it is missing), then as arrays: the path of
    ``demos_mjrender.npz`` in ``--out``."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data import playback
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        demo_file_arrays,
        save_demos_npz,
    )

    missing = playback.missing_render_modules()
    if missing:
        raise ValueError(
            f"the mjrender fixture is rendered by MuJoCo and written with "
            f"h5py, and this host lacks {' and '.join(missing)}: pass "
            "--frames with the demos_mjrender.npz that --render-only "
            "writes on a host with mujoco and h5py")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "demos_mjrender.hdf5")
    npz = os.path.join(args.out, "demos_mjrender.npz")
    if not os.path.exists(path):
        src = playback.write_states_fixture(
            os.path.join(args.out, "states_mj.hdf5"),
            n_demos=args.demos, steps=args.demo_steps, seed=7)
        playback.render_playback_dataset(src, path, cameras=("agentview",),
                                         image_hw=args.image_hw,
                                         target_body="cube")
    if not os.path.exists(npz):
        save_demos_npz(npz, *demo_file_arrays(path))
    return npz


def fixture_demos(args: argparse.Namespace, name: str) -> List[Dict]:
    """The demos of fixture ``name`` at the battery's size, built in
    memory exactly as the reference's fixture_path writes them; the
    mjrender fixture's from ``--frames``, or rendered here."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        demo_fixture_arrays,
        load_demos_npz,
    )

    if name == "mjrender":
        return load_demos_npz(args.frames or render_mjrender(args))[0]
    kw = dict(FIXTURES[name])
    kw.setdefault("cameras", ("agentview",))
    kw.setdefault("seed", 7)
    return list(demo_fixture_arrays(n_demos=args.demos,
                                    steps=args.demo_steps,
                                    image_hw=args.image_hw, **kw))


def row_key(args: argparse.Namespace, name: str) -> str:
    return name if not args.seed else f"{name} (seed{args.seed})"


def row_config(args: argparse.Namespace, name: str, paths: Dict[str, str],
               ckpt_dir: str):
    """(cfg, eval_drop, val_fixture) of row ``name``: preset pr3 with the
    reference's battery settings, the row's overrides and --seed/--set;
    ``paths`` maps a fixture name to its data.path (a file, or the
    fixture's own name for the in-memory stores)."""
    from rgb_proprioceptive_pose_estimator_tpu_torch import preset
    from rgb_proprioceptive_pose_estimator_tpu_torch.cli import _parse_value

    over = dict({**ROWS, **PORT_ROWS}[name])
    row_fixture = paths[over.pop("_fixture", "plain")]
    val_fixture = over.pop("_val_fixture", "")
    eval_drop = over.pop("_eval_drop", ())
    if val_fixture:
        # separate clean held-out file replaces fraction splitting
        over.setdefault("data.val_path", paths[val_fixture])
        over.setdefault("data.val_fraction", 0.0)
    if args.seed is not None:
        over["train.seed"] = args.seed
    for item in args.set:
        k, v = item.split("=", 1)
        over[k] = _parse_value(v)
    cfg = preset("pr3").override(**{
        "data.path": row_fixture,
        "data.batch_size": args.batch,
        "data.val_fraction": 0.2,       # demo-granularity held-out split
        "data.augment_device": True,
        "data.crop_margin": 4,
        "data.device_cache": True,
        "train.steps": args.steps,
        "train.steps_per_call": 1,
        "train.lr": 3e-4,
        "train.lr_schedule": "cosine",
        "train.warmup_steps": 100,
        "train.eval_every": 500,
        "train.eval_steps": 0,          # full held-out split each eval
        "train.ckpt_every": 0,
        "train.ckpt_best_metric": "pos_mae_cm",
        "train.ckpt_dir": ckpt_dir,
        "train.log_every": 250,
        # one card: pr3's 0 would take every visible one
        "dist.num_devices": 1,
        **over,
    })
    return cfg, eval_drop, val_fixture


def _rounded(m: Dict[str, Any], args: argparse.Namespace,
             held_out: int) -> Dict[str, Any]:
    return {"pos_mae_cm": round(m["pos_mae_cm"], 2),
            "rot_mae_deg": round(m["rot_mae_deg"], 2),
            "steps": args.steps, "held_out_demos": held_out}


def train_and_score(cfg, fixtures: Dict[str, List], eval_drop: Sequence,
                    device) -> Dict[str, Any]:
    """Train ``cfg`` on ``device`` from the in-memory ``fixtures`` (its
    data.path and data.val_path name entries), then score its best
    checkpoint over the whole held-out split, and once more with each
    ``eval_drop`` entry's camera(s) dead (a tuple entry drops the set
    jointly). Returns {"metrics": evaluate_on's, "dead": {"<cam>[+<cam>]":
    metrics}, "seconds"}."""
    import torch

    from rgb_proprioceptive_pose_estimator_tpu_torch import api
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        build_dataset,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import (
        train_on,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )

    t0 = time.perf_counter()
    train_store = build_dataset(cfg, "train", fixtures=fixtures)
    val_store = build_dataset(cfg, "val", fixtures=fixtures)
    state = create_state(cfg, device)
    train_on(cfg, state, train_store, val_store)
    del state
    model, step = api.load_model(cfg, f"{cfg.train.ckpt_dir}/best",
                                 device=device)
    metrics = api.evaluate_on(cfg, model, val_store, step=step)
    dead = {}
    for dc in eval_drop:
        dcs = tuple(dc) if isinstance(dc, (tuple, list)) else (dc,)
        dead["+".join(dcs)] = api.evaluate_on(cfg, model, val_store,
                                              step=step, drop_cameras=dcs)
    seconds = time.perf_counter() - t0
    del model, train_store, val_store
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"metrics": metrics, "dead": dead, "seconds": seconds}


def run_row(args: argparse.Namespace, name: str, cache: Dict[str, List],
            device) -> Dict[str, Any]:
    """Train row ``name`` on ``device`` and score its best checkpoint.
    ``cache`` keeps the fixtures built so far (name -> demos). Returns
    {"results": {key: entry in the reference's format}, "seconds",
    "cfg", "fixtures"}."""
    over = {**ROWS, **PORT_ROWS}[name]
    row_fixture = over.get("_fixture", "plain")
    used = [row_fixture] + (
        [over["_val_fixture"]] if "_val_fixture" in over else [])
    for f in used:
        if f not in cache:
            cache[f] = fixture_demos(args, f)
    fixtures = {f: cache[f] for f in used}
    key = row_key(args, name)
    ckpt_dir = os.path.join(args.out, key.split()[0].replace("+", "_"))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, eval_drop, val_fixture = row_config(
        args, name, {f: f for f in FIXTURES}, ckpt_dir)
    out = train_and_score(cfg, fixtures, eval_drop, device)
    # the held-out split: a separate val fixture whole, else 20% of the
    # row's demos (the rendered fixture's count is its arrays')
    n_demos = len(fixtures[row_fixture])
    held_out = args.demos if val_fixture else int(n_demos * 0.2)
    results = {key: _rounded(out["metrics"], args, held_out)}
    print(json.dumps({key: results[key]}), flush=True)
    for cams, r in out["dead"].items():
        dkey = f"{key} [dead {cams}]"
        results[dkey] = _rounded(r, args, int(n_demos * 0.2))
        print(json.dumps({dkey: results[dkey]}), flush=True)
    return {"results": results, "seconds": out["seconds"], "cfg": cfg,
            "fixtures": fixtures}


def sample_labels(store):
    """(pos, quat) label of every sample of an HDF5DemoStore split."""
    idx = store._index
    lab = store._demo_off[idx[:, 0]] + idx[:, 1] + store.target_lookahead
    return store._pos_flat[lab], store._quat_flat[lab]


def chance_level(cfg, fixtures: Dict[str, List]) -> Dict[str, float]:
    """The held-out MAE of predicting, for every held-out sample, the
    train split's mean position and its mean orientation (the unit
    quaternion maximizing the sum of squared dot products with the train
    split's, sign-free): what a model that ignores its inputs scores."""
    import torch

    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        build_dataset,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
        pose_errors,
    )

    # labels only: no camera is read
    lcfg = cfg.override(**{"model.backbone": "none",
                           "model.camera_dropout": 0.0,
                           "data.device_cache": False,
                           "data.cache_layout": "replicated"})
    pos, quat = sample_labels(build_dataset(lcfg, "train", fixtures=fixtures))
    vpos, vquat = sample_labels(build_dataset(lcfg, "val", fixtures=fixtures))
    q64 = quat.astype(np.float64)
    mean_q = np.linalg.eigh(q64.T @ q64)[1][:, -1]
    n = len(vpos)
    pe, re_ = pose_errors(
        torch.from_numpy(np.broadcast_to(pos.mean(0), (n, 3)).copy()),
        torch.from_numpy(np.broadcast_to(mean_q.astype(np.float32),
                                         (n, 4)).copy()),
        torch.from_numpy(vpos), torch.from_numpy(vquat))
    return {"pos_mae_cm": float(pe.mean()), "rot_mae_deg": float(re_.mean())}


def card() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi not read")


def _load(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _dump(obj: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the rows ``args.rows`` names (all when empty), accumulating
    results.json and runs.json in ``args.out``; returns the results."""
    import torch

    from rgb_proprioceptive_pose_estimator_tpu_torch.api import resolve_device

    device = resolve_device(args.device)     # no CPU fallback
    all_rows = {**ROWS, **PORT_ROWS}
    want = ([r.strip() for r in args.rows.split(",") if r.strip()]
            if args.rows else list(all_rows))
    unknown = [r for r in want if r not in all_rows]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {list(all_rows)}")
    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "results.json")
    runs_path = os.path.join(args.out, "runs.json")
    results, runs = _load(results_path), _load(runs_path)
    where = card() if device.type == "cuda" else "cpu"
    cache: Dict[str, List] = {}
    for name in want:
        out = run_row(args, name, cache, device)
        results.update(out["results"])
        cfg = out["cfg"]
        runs[row_key(args, name)] = {
            "seconds": round(out["seconds"], 1), "card": where,
            "dtype": cfg.model.dtype, "train_seed": cfg.train.seed,
            "cudnn_tf32": bool(torch.backends.cudnn.allow_tf32),
            "matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "demos": args.demos, "steps": args.steps, "batch": args.batch,
            "torch": torch.__version__, **({"note": args.note}
                                           if args.note else {})}
        _dump(results, results_path)
        _dump(runs, runs_path)
        print(json.dumps({"run": row_key(args, name),
                          **runs[row_key(args, name)]}), flush=True)
    print(json.dumps(results))
    return results


def _base(key: str) -> str:
    """The row of a results key: "<row> (seedN)" -> "<row>"."""
    head, _, tail = key.rpartition(" (seed")
    return head if head and tail.rstrip(")").isdigit() else key


def collect(dirs: Sequence[str], artifact: str) -> Dict[str, Any]:
    """Merge the runs of ``dirs`` into ``artifact``: every run, and per
    reference row the port's values (min-max over its seeds) against the
    reference's, inside or outside the band; the five readings."""
    runs: Dict[str, Any] = {}
    for d in dirs:
        res = _load(os.path.join(d, "results.json"))
        meta = _load(os.path.join(d, "runs.json"))
        for key, r in res.items():
            # a dead-camera score shares its row's run
            runs[key] = {**r, **meta.get(key.split(" [dead ")[0], {})}
    table = {}
    held_to = {**REFERENCE, "image+scaled-proprio (raw normalize-off)":
               REFERENCE["image+scaled-proprio (raw)"]}
    for row, (demos, steps, rpos, rrot) in held_to.items():
        got = [v for k, v in runs.items() if _base(k) == row]
        if not got:
            table[row] = {"reference": [rpos, rrot], "port": None}
            continue
        pos = [v["pos_mae_cm"] for v in got]
        rot = [v["rot_mae_deg"] for v in got]
        mpos = max(BAND_POS_CM, BAND_REL * rpos)
        mrot = max(BAND_ROT_DEG, BAND_REL * rrot)
        inside = (min(pos) - mpos <= rpos <= max(pos) + mpos
                  and min(rot) - mrot <= rrot <= max(rot) + mrot)
        table[row] = {
            "reference": [rpos, rrot], "reference_demos_steps": [demos, steps],
            "port_pos_mae_cm": [min(pos), max(pos)],
            "port_rot_mae_deg": [min(rot), max(rot)],
            "runs": len(got), "band": [round(mpos, 2), round(mrot, 2)],
            "in_band": inside,
            "demos_steps": sorted({(v.get("demos"), v["steps"])
                                   for v in got}),
            "seconds": [v.get("seconds") for v in got]}

    def pos(row):
        r = runs.get(row)
        return None if r is None else r["pos_mae_cm"]

    def reading(a, b, factor=1.0):
        # row a beats row b by ``factor`` on pos MAE (seed-0 runs)
        pa, pb = pos(a), pos(b)
        return None if pa is None or pb is None else pa * factor <= pb

    readings = {
        "proprio-only at chance, >= 3x image-only": reading(
            "image-only", "proprio-only (control)", 3.0),
        "dual-cam beats single-cam (occluded)": reading(
            "dual-cam (occluded)", "single-cam (occluded)"),
        "proprio dropout beats image+proprio": reading(
            "image+proprio (dropout)", "image+proprio"),
        "normalized beats raw by >= 3x": reading(
            "image+scaled-proprio (normalized)",
            "image+scaled-proprio (raw)", 3.0),
        "normalized beats raw (normalize off) by >= 3x": reading(
            "image+scaled-proprio (normalized)",
            "image+scaled-proprio (raw normalize-off)", 3.0),
        "temporal-lstm beats single-frame (velocity)": reading(
            "temporal-lstm (velocity)", "single-frame (velocity)"),
    }
    scored = [t for r, t in table.items() if r in REFERENCE and "in_band" in t]
    out = {
        "what": "held-out pos/rot MAE of the PyTorch/CUDA port "
                "(scripts/torch_accuracy_artifact.py) beside the JAX "
                "package's figures (TPU v5e, accuracy only, "
                "docs/DESIGN.md:528-560)",
        "cards": sorted({v.get("card", "?") for v in runs.values()}),
        "band": f"pos within max({BAND_POS_CM} cm, {BAND_REL:.0%}), rot "
                f"within max({BAND_ROT_DEG} deg, {BAND_REL:.0%}); seeded "
                "rows: the reference inside the port's min-max widened "
                "by both",
        "rows_in_band": f"{sum(t['in_band'] for t in scored)} of "
                        f"{len(REFERENCE)}",
        "readings": readings, "table": table, "runs": runs}
    if artifact:
        _dump(out, artifact)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.collect:
        out = collect(args.collect, args.artifact)
        print(json.dumps({k: out[k] for k in ("rows_in_band", "readings")}))
        return out
    if args.render_only:
        out = {"frames": render_mjrender(args)}
        print(json.dumps(out))
        return out
    return run(args)


if __name__ == "__main__":
    main()
