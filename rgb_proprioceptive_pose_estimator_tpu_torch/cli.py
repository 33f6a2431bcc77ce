"""CLI of the port on top of its public API (counterpart of the JAX
package's ``cli.py``), with the same subcommands and flags.

Usage:
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli train \
        --preset pr3 --set data.path=/data/demo.hdf5 --set train.steps=20000
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli eval \
        --preset pr3 --set train.ckpt_dir=/tmp/ckpt --percentiles
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli config --preset pr4
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli info --preset pr4
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli serve \
        --preset pr3 --set train.ckpt_dir=/tmp/ckpt --port 8080
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli export \
        --preset pr3 --set train.ckpt_dir=/tmp/ckpt --quantize int8
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli sweep \
        --preset pr1 --grid "train.lr=1e-3|3e-4" --out /tmp/sweep
    python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli inspect \
        --set "data.path=/data/lift*.hdf5"

``train``, ``eval``, ``predict``, ``serve`` and ``sweep`` run on
``--device`` (default cuda; ``--device cpu`` runs the kernels' plain
versions on the CPU); ``train`` and ``eval`` with ``dist.num_devices``
resolving to N > 1 run N data-parallel processes, one per card
(``api.train``, ``api.evaluate``). ``serve`` is the HTTP pose server
(utils/serve.py), the JAX package's wire protocol. ``export`` writes a
``torch.export`` artifact (utils/export.py) traced on the CPU, which
``utils.export.load_predictor`` serves on any device. ``info`` prints the
reference's report, and on stderr the device count that
``dist.num_devices`` resolves to. ``inspect``, ``curves``, ``repack``,
``render`` and ``predict --plot`` need h5py, matplotlib or MuJoCo: on a
host without the one they need they exit with status 1 naming it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Any, Dict, Iterator

from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    PRESETS,
    Config,
    preset,
)

COMMANDS = ("train", "eval", "predict", "export", "config", "presets",
            "info", "inspect", "curves", "render", "serve", "repack",
            "sweep")


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        pass
    if "," in s:
        # bare comma list for tuple fields: --set data.crop_ratio=0.75,1.333
        try:
            return [json.loads(p) for p in s.split(",")]
        except json.JSONDecodeError:
            pass
    # a plain string; Config.override splits it on commas for a tuple
    # field (--set model.cameras=agentview,robot0_eye_in_hand)
    return s


def load_config(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = preset(args.preset)
    overrides = {}
    for item in args.set or []:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        k, v = item.split("=", 1)
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = cfg.override(**overrides)
    return cfg


def devices_info(cfg: Config, device: str) -> str:
    """The data-parallel width dist.num_devices resolves to on
    ``device``'s kind (parallel/dist.resolve_num_devices), as a line."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

    head = f"devices: dist.num_devices={cfg.dist.num_devices} on {device}"
    try:
        return f"{head} resolves to {dist.resolve_num_devices(cfg, device)}"
    except (RuntimeError, ValueError) as e:
        return f"{head}: {e}"


def model_info(cfg: Config) -> Dict[str, Any]:
    """The JAX CLI's ``info`` report: the model built on the meta device
    (no memory, no compute), its parameters per top-level module, and
    the input shapes of a batch of 1."""
    import torch

    from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
        PoseEstimator,
    )

    m = cfg.model
    with torch.device("meta"):
        model = PoseEstimator(m)
    per: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        per[top] = per.get(top, 0) + p.numel()
    per = dict(sorted(per.items()))
    total = sum(per.values())
    frames = (m.temporal_frames,) if m.temporal_frames > 1 else ()
    inputs: Dict[str, Any] = {}
    if m.backbone != "none":
        inputs["images"] = {c: [1, *frames, m.image_size, m.image_size, 3]
                            for c in m.cameras}
    if m.use_proprio:
        inputs["proprio"] = [1, *frames, m.proprio_dim]
    inputs["target_pos"] = [1, 3]
    inputs["target_quat"] = [1, 4]
    return {
        "name": cfg.name,
        "backbone": m.backbone,
        "cameras": list(m.cameras),
        "image_size": m.image_size,
        "temporal_frames": m.temporal_frames,
        "compute_dtype": m.dtype,
        "inputs": inputs,
        "params_total": total,
        "params_mib_f32": round(total * 4 / 2**20, 2),
        "params_by_module": per,
        "batch_stats_elems": sum(b.numel() for b in model.buffers()),
    }


def inspect_dataset(cfg: Config) -> dict:
    """Walk the demo file(s) named by data.path and report what's inside --
    the first thing a user migrating robomimic/robosuite data runs, BEFORE
    they know the right config. Pure h5py metadata reads (no pixel data, no
    accelerator), so it is instant even for multi-GB files.

    Reports per file: demo count, step count, env attrs, mask/ filter keys;
    plus the union of obs keys with shape/dtype/encoding (per-frame
    JPEG/PNG vlen datasets are detected), the cameras inferred from
    data.image_key_format, and ready-to-paste config suggestions
    (data.proprio_key candidates with their widths, target-key check)."""
    import h5py
    import numpy as np

    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        expand_paths,
    )

    if cfg.data.source != "hdf5" or not cfg.data.path:
        raise SystemExit("inspect requires an hdf5 data source "
                         "(set data.path)")
    paths = expand_paths(cfg.data.path)

    # the configured image key format, inverted to detect cameras:
    # "obs/{camera}_image" -> keys under obs/ ending in "_image"
    fmt = cfg.data.image_key_format
    prefix, _, suffix = fmt.partition("{camera}")

    files = []
    obs_keys: dict = {}           # key -> {shape, dtype, encoding, files}
    cameras = set()
    for p in paths:
        with h5py.File(p, "r") as f:
            if "data" not in f:
                files.append({"path": p, "error": "no 'data' group "
                              "(not a robomimic-layout file)"})
                continue
            data = f["data"]
            demo_names = sorted(data.keys())
            n_steps = 0
            n_states_only = 0
            for d in demo_names:
                g = data[d]
                if "num_samples" in g.attrs:
                    n_steps += int(g.attrs["num_samples"])
                elif "obs" in g:
                    first = g["obs"][next(iter(g["obs"].keys()))]
                    n_steps += int(first.shape[0])
                elif "states" in g:
                    # robosuite state-playback layout: no rendered obs
                    n_steps += int(g["states"].shape[0])
                    n_states_only += 1
            # obs inventory from the FIRST demo (metadata only)
            if demo_names and "obs" in data[demo_names[0]]:
                obs = data[demo_names[0]]["obs"]
                for k in sorted(obs.keys()):
                    ds = obs[k]
                    vlen = h5py.check_vlen_dtype(ds.dtype) is not None
                    enc = "vlen-encoded (JPEG/PNG per frame)" if vlen else (
                        "raw")
                    ent = obs_keys.setdefault(f"obs/{k}", {
                        "shape_per_demo": list(ds.shape),
                        "dtype": "bytes" if vlen else str(ds.dtype),
                        "encoding": enc, "files": 0})
                    ent["files"] += 1
                    # files may disagree (e.g. one stores raw pixels,
                    # another per-frame JPEG) -- surface that instead of
                    # silently reporting the first file's layout
                    if ent["encoding"] != enc:
                        ent["encoding"] = "MIXED across files"
                    new_dt = "bytes" if vlen else str(ds.dtype)
                    if ent["dtype"] != new_dt:
                        ent["dtype"] = "MIXED across files"
                    if ent["shape_per_demo"][1:] != list(ds.shape)[1:]:
                        ent["shape_per_demo"] = "MIXED across files"
                    full = f"obs/{k}"
                    if full.startswith(prefix) and full.endswith(suffix) \
                            and len(full) > len(prefix) + len(suffix):
                        cameras.add(full[len(prefix):len(full)-len(suffix)]
                                    if suffix else full[len(prefix):])
            masks = {}
            if "mask" in f:
                for m in sorted(f["mask"].keys()):
                    masks[m] = int(f["mask"][m].shape[0])
            row = {
                "path": p,
                "demos": len(demo_names),
                "steps": n_steps,
                "env": str(data.attrs.get("env", "")),
                "filter_keys (data.filter_key)": masks,
            }
            if n_states_only:
                row["states_only_demos"] = n_states_only
                row["hint"] = ("state-playback layout (no rendered obs): "
                               "materialize observations with `cli render "
                               f"--src {p} --out rendered.hdf5 "
                               "--target-body <body>`")
                # enumerate target candidates from the embedded MJCF
                # (model load only -- no GL, still metadata-cheap)
                xml = data[demo_names[0]].attrs.get(
                    "model_file", data.attrs.get("model_file", ""))
                if xml:
                    try:
                        import mujoco

                        if isinstance(xml, bytes):
                            xml = xml.decode()
                        mdl = mujoco.MjModel.from_xml_string(xml)
                        free = [
                            mujoco.mj_id2name(
                                mdl, mujoco.mjtObj.mjOBJ_BODY,
                                int(mdl.jnt_bodyid[j]))
                            for j in range(mdl.njnt)
                            if int(mdl.jnt_type[j]) == 0]  # free joints
                        row["target_body_candidates (free bodies)"] = free
                        row["target_site_candidates"] = [
                            mujoco.mj_id2name(
                                mdl, mujoco.mjtObj.mjOBJ_SITE, i)
                            for i in range(mdl.nsite)]
                        row["cameras_in_model (model.cameras)"] = [
                            mujoco.mj_id2name(
                                mdl, mujoco.mjtObj.mjOBJ_CAMERA, i)
                            for i in range(mdl.ncam)]
                    except Exception as e:  # asset refs, no mujoco, ...
                        row["model_file_note"] = (
                            f"embedded MJCF did not load: {e!r:.120}")
            files.append(row)

    # config suggestions: low-dim float keys are proprio candidates; the
    # configured target/proprio keys are checked against what exists
    proprio_candidates = {
        k: v["shape_per_demo"][1:] for k, v in obs_keys.items()
        if v["encoding"] == "raw" and len(v["shape_per_demo"]) == 2
        and not v["dtype"].startswith("uint")
    }
    configured_proprio = [k.strip() for k in
                          cfg.data.proprio_key.split(",") if k.strip()]
    target_keys = [k.strip() for k in cfg.data.target_key.split(",")
                   if k.strip()]
    suggestions = {
        "cameras_detected (model.cameras)": sorted(cameras),
        "proprio_candidates (data.proprio_key; widths concat)":
            proprio_candidates,
        "target_key_present": all(k in obs_keys for k in target_keys),
        "configured_proprio_present":
            {k: k in obs_keys for k in configured_proprio},
    }
    return {"files": files,
            "demos_total": sum(x.get("demos", 0) for x in files),
            "steps_total": sum(x.get("steps", 0) for x in files),
            "obs_keys": obs_keys,
            "suggestions": suggestions}


@contextlib.contextmanager
def _needs(command: str) -> Iterator[None]:
    """A package the command imports and this host lacks (h5py,
    matplotlib, mujoco) ends it naming the package, with no fallback."""
    try:
        yield
    except ImportError as e:
        raise SystemExit(f"{command}: a package it needs is missing on "
                         f"this host: {e}") from e


def _predict(cfg: Config, args, ckpt_step) -> None:
    """Run the checkpointed model over one demo's steps of data.path and
    print predicted against target pose, then the MAE."""
    import numpy as np
    import torch

    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        build_dataset,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
        pose_metrics,
    )

    if cfg.data.source != "hdf5":
        raise SystemExit("predict requires an hdf5 data source "
                         "(set data.path)")
    if args.plot and args.t != -1:
        raise SystemExit("--plot plots a whole trajectory; drop --t")
    ds = build_dataset(cfg)
    flat = np.nonzero(ds._index[:, 0] == args.demo)[0]
    if flat.size == 0:
        raise SystemExit(f"demo {args.demo} not found")
    if args.t != -1:
        if not 0 <= args.t < flat.size:
            raise SystemExit(
                f"--t {args.t} out of range for demo {args.demo} "
                f"({flat.size} steps; -1 = all)")
        flat = flat[args.t:args.t + 1]
    batch = ds.get_batch(flat, augment=False, seed=0)
    tpos = np.asarray(batch.pop("target_pos"), np.float32)
    tquat = np.asarray(batch.pop("target_quat"), np.float32)
    pred = rppt.Predictor(cfg, ckpt_dir=args.ckpt_dir or None,
                          step=ckpt_step, max_batch=min(len(flat), 32),
                          device=args.device)
    pos, quat = pred(batch)
    m = pose_metrics(*(torch.from_numpy(a) for a in (pos, quat, tpos, tquat)))
    for i in range(len(flat)):
        print(json.dumps({
            "t": int(ds._index[flat[i]][1]),
            "pred_pos": [round(float(v), 4) for v in pos[i]],
            "target_pos": [round(float(v), 4) for v in tpos[i]],
            "pred_quat": [round(float(v), 4) for v in quat[i]],
        }))
    summary = {"pos_mae_cm": round(float(m["pos_mae_cm"]), 3),
               "rot_mae_deg": round(float(m["rot_mae_deg"]), 3)}
    if args.plot:
        from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
            pose_errors,
        )
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.viz import (
            plot_trajectory,
        )

        pe, re_ = pose_errors(*(torch.from_numpy(a)
                                for a in (pos, quat, tpos, tquat)))
        with _needs("predict --plot"):
            summary["plot"] = plot_trajectory(
                pos, tpos, pe.numpy(), re_.numpy(), args.plot,
                title=(f"demo {args.demo}: pos MAE "
                       f"{summary['pos_mae_cm']} cm / rot MAE "
                       f"{summary['rot_mae_deg']} deg @ step "
                       f"{int(pred.step)}"))
    print(json.dumps(summary))


def _render(cfg: Config, args) -> None:
    """State-playback ingestion (data/playback.py), as the reference's
    ``render``: one output file, or a directory of them for several
    sources."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        expand_paths,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.playback import (
        render_playback_dataset,
    )

    if not args.src:
        raise SystemExit("render requires --src (states demo "
                         "file(s); comma lists and globs accepted)")
    try:
        srcs = expand_paths(args.src)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e).replace("data.path", "--src"))
    missing = [p for p in srcs if not os.path.isfile(p)]
    if missing:
        raise SystemExit(f"--src file(s) not found: {missing}")
    kw = dict(cameras=tuple(cfg.model.cameras),
              image_hw=cfg.model.image_size,
              target_body=args.target_body,
              target_site=args.target_site, max_demos=args.max_demos,
              encoding=args.encode)
    multi = (len(srcs) > 1 or args.out.endswith(os.sep)
             or os.path.isdir(args.out or "rendered.hdf5"))
    try:
        if not multi:
            out_path = args.out or "rendered.hdf5"
            summary = render_playback_dataset(srcs[0], out_path, **kw)
            outs = [out_path]
        else:
            out_dir = (args.out or "rendered").rstrip(os.sep)
            os.makedirs(out_dir, exist_ok=True)
            outs, summary = [], {"demos": 0, "frames": 0}
            used = set()
            for i, src in enumerate(srcs):
                stem = os.path.splitext(os.path.basename(src))[0]
                if stem in used:
                    stem = f"{stem}_{i}"
                used.add(stem)
                dst = os.path.join(out_dir, f"{stem}_rendered.hdf5")
                one = render_playback_dataset(src, dst, **kw)
                summary["demos"] += one["demos"]
                summary["frames"] += one["frames"]
                outs.append(dst)
            summary.update(cameras=len(cfg.model.cameras),
                           image_hw=cfg.model.image_size, files=len(srcs))
    except ValueError as e:
        raise SystemExit(str(e))
    summary["out"] = outs if len(outs) > 1 else outs[0]
    summary["next"] = (f"train with data.path={','.join(outs)} "
                       "data.proprio_key=obs/qpos,obs/qvel "
                       "data.target_key=obs/object")
    print(json.dumps(summary))


def _repack(cfg: Config, args) -> None:
    """Offline resize/re-encode (data/repack.py), as the reference's
    ``repack``."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
        expand_paths,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.repack import (
        repack_file,
    )

    if not args.src:
        raise SystemExit("repack requires --src (demo file(s); comma "
                         "lists and globs accepted)")
    try:
        srcs = expand_paths(args.src)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e).replace("data.path", "--src"))
    size = args.size or cfg.model.image_size
    kw = dict(cameras=tuple(cfg.model.cameras), size=size,
              encode=args.encode, max_demos=args.max_demos,
              image_key_format=cfg.data.image_key_format,
              use_native=cfg.data.use_native)
    multi = (len(srcs) > 1 or args.out.endswith(os.sep)
             or os.path.isdir(args.out or "repacked.hdf5"))
    try:
        if not multi:
            out_path = args.out or "repacked.hdf5"
            summary = dict(repack_file(srcs[0], out_path, **kw))
            outs = [out_path]
        else:
            out_dir = (args.out or "repacked").rstrip(os.sep)
            os.makedirs(out_dir, exist_ok=True)
            outs = []
            summary = {"demos": 0, "frames": 0, "bytes_in": 0,
                       "bytes_out": 0}
            used = set()
            for i, src in enumerate(srcs):
                stem = os.path.splitext(os.path.basename(src))[0]
                if stem in used:
                    stem = f"{stem}_{i}"
                used.add(stem)
                dst = os.path.join(out_dir, f"{stem}_repacked.hdf5")
                one = repack_file(src, dst, **kw)
                for k in ("demos", "frames", "bytes_in", "bytes_out"):
                    summary[k] += one[k]
                outs.append(dst)
            summary["files"] = len(srcs)
    except (ValueError, KeyError) as e:
        raise SystemExit(str(e))
    summary.update(size=size, encode=args.encode,
                   out=outs if len(outs) > 1 else outs[0],
                   next=f"train with data.path={','.join(outs)}")
    print(json.dumps(summary))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rppt")
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("--preset", default="pr1", choices=sorted(PRESETS))
    ap.add_argument("--config", default="", help="JSON config file")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="dotted config override, repeatable")
    ap.add_argument("--device", default="cuda",
                    help="train/eval/predict/serve/sweep: torch device (cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default="", help="eval/predict: checkpoint dir")
    ap.add_argument("--step", default="0",
                    help="eval/predict/export: checkpoint step (0 = "
                         "latest; 'best' = the train.ckpt_best_metric "
                         "checkpoint under <ckpt_dir>/best)")
    ap.add_argument("--demo", type=int, default=0,
                    help="predict: demo index in data.path")
    ap.add_argument("--t", type=int, default=-1,
                    help="predict: timestep (-1 = all steps of the demo)")
    ap.add_argument("--out", default="",
                    help="output path -- export: artifact (default "
                         "pose.rppe); render: rendered file (default "
                         "rendered.hdf5); repack: repacked file (default "
                         "repacked.hdf5); curves: figure (default "
                         "curves.png); sweep: run directory (default "
                         "sweep)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="export: the artifact's batch size; serve: the "
                         "Predictor's largest batch per call")
    ap.add_argument("--quantize", default="none", choices=["none", "int8"],
                    help="export: weight-only int8 quantization")
    ap.add_argument("--per-demo", action="store_true",
                    help="eval: add a per-trajectory MAE breakdown "
                         "(hdf5 source only)")
    ap.add_argument("--percentiles", action="store_true",
                    help="eval: add per-sample error quantiles "
                         "(pos cm / rot deg p50/p90/p95/max)")
    ap.add_argument("--success-at", default="", metavar="CM:DEG[,CM:DEG...]",
                    help="eval: success-rate thresholds, e.g. '2:10,5:30'")
    ap.add_argument("--drop-camera", action="append", default=[],
                    metavar="CAM",
                    help="eval: score this camera as dead (repeatable)")
    ap.add_argument("--plot", default="", metavar="PNG",
                    help="predict: also write a predicted-vs-target "
                         "trajectory figure (whole-demo mode only)")
    ap.add_argument("--dump-predictions", default="", metavar="NPZ",
                    help="eval: write every per-sample prediction to an npz")
    ap.add_argument("--src", default="", metavar="HDF5",
                    help="render: state-playback demo file(s) "
                         "(robosuite layout: data/demo_N/states + "
                         "model_file attr); repack: image-bearing demo "
                         "file(s) to resize/re-encode")
    ap.add_argument("--size", type=int, default=0,
                    help="repack: output image resolution (0 = "
                         "model.image_size)")
    ap.add_argument("--target-body", default="cube",
                    help="render: MuJoCo body whose world pose becomes "
                         "obs/object")
    ap.add_argument("--target-site", default="",
                    help="render: MuJoCo site as the pose target instead "
                         "of --target-body")
    ap.add_argument("--max-demos", type=int, default=0,
                    help="render/repack: cap demos per file (0 = all)")
    ap.add_argument("--encode", default="raw",
                    choices=["raw", "jpeg", "png"],
                    help="render/repack: image storage (jpeg/png = "
                         "per-frame vlen bytes)")
    ap.add_argument("--metrics", default="", metavar="JSONL",
                    help="curves: metrics file (default "
                         "<train.ckpt_dir>/metrics.jsonl or "
                         "train.metrics_path)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="serve: bind address (0.0.0.0 exposes the daemon "
                         "beyond this host)")
    ap.add_argument("--port", type=int, default=8080,
                    help="serve: TCP port (0 = pick a free one)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="serve: skip the warmup call")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="serve: micro-batch concurrent single-obs "
                         "requests arriving within this window into one "
                         "device call (0 = off; try 2-5 under multi-client "
                         "load)")
    ap.add_argument("--max-body-mb", type=float, default=64.0,
                    help="serve: refuse request bodies above this size "
                         "with 413 before reading them")
    ap.add_argument("--read-timeout-s", type=float, default=30.0,
                    help="serve: per-connection socket timeout; a request "
                         "stalling mid-body this long gets 408 (0 = no "
                         "timeout)")
    ap.add_argument("--grid", default="", metavar="SPEC",
                    help='sweep: grid spec "train.lr=1e-3|3e-4; '
                         'model.proprio_dropout=0|0.5" (";" between keys, '
                         '"|" between alternatives; values parse like '
                         "--set). Runs the cross product, resumable")
    ap.add_argument("--metric", default="eval_pos_mae_cm",
                    help="sweep: fit() metrics key that picks the best "
                         "run (lower = better)")
    ap.add_argument("--sample", default="", metavar="PNG",
                    help="inspect: also write a decoded sample-frame grid "
                         "(first frame per camera x up to 4 demos)")
    args = ap.parse_args(argv)

    if args.step == "best":
        ckpt_step = "best"
    else:
        try:
            ckpt_step = int(args.step) or None
        except ValueError:
            raise SystemExit(
                f"--step must be an integer or 'best', got {args.step!r}")

    if args.command == "presets":
        for name in sorted(PRESETS):
            print(f"{name}: {PRESETS[name]().name}")
        return 0

    cfg = load_config(args)
    if args.command == "config":
        print(cfg.to_json())
        return 0
    if args.command == "info":
        print(json.dumps(model_info(cfg), indent=2))
        print(devices_info(cfg, args.device), file=sys.stderr)
        return 0
    if args.command == "render":
        with _needs("render"):
            _render(cfg, args)
        return 0
    if args.command == "repack":
        with _needs("repack"):
            _repack(cfg, args)
        return 0
    if args.command == "curves":
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.viz import (
            plot_metrics,
        )

        src = (args.metrics or cfg.train.metrics_path
               or os.path.join(cfg.train.ckpt_dir, "metrics.jsonl"))
        if not os.path.exists(src):
            raise SystemExit(f"no metrics file at {src} (train first, or "
                             "pass --metrics)")
        try:
            with _needs("curves"):
                print(json.dumps(plot_metrics(src, args.out or "curves.png")))
        except ValueError as e:
            raise SystemExit(str(e))
        return 0
    if args.command == "inspect":
        with _needs("inspect"):
            report = inspect_dataset(cfg)
            if args.sample:
                from rgb_proprioceptive_pose_estimator_tpu_torch.utils.viz import (
                    save_sample_grid,
                )

                try:
                    report["sample"] = save_sample_grid(cfg, args.sample)
                except ValueError as e:
                    raise SystemExit(str(e))
        print(json.dumps(report, indent=2))
        return 0
    if args.command == "sweep":
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.sweep import (
            run_sweep,
        )

        if not args.grid:
            raise SystemExit('sweep requires --grid "KEY=V1|V2; ..."')
        try:
            summary = run_sweep(cfg, args.grid, args.out or "sweep",
                                metric=args.metric, device=args.device)
        except (ValueError, KeyError) as e:
            raise SystemExit(str(e))
        print(json.dumps(summary, indent=2))
        return 0
    if args.command == "export":
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.export import (
            export_predictor,
        )

        path = export_predictor(args.out or "pose.rppe", cfg,
                                ckpt_dir=args.ckpt_dir or None,
                                step=ckpt_step, max_batch=args.max_batch,
                                quantize=args.quantize)
        print(json.dumps({"exported": path, "bytes": os.path.getsize(path),
                          "max_batch": args.max_batch,
                          "quantize": args.quantize}))
        return 0

    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt

    if args.command == "train":
        out = rppt.train(cfg, device=args.device)
        print(json.dumps(out["metrics"], indent=2))
        return 0
    if args.command == "eval":
        success_at = []
        for pair in filter(None, args.success_at.split(",")):
            try:
                cm, deg = pair.split(":")
                success_at.append((float(cm), float(deg)))
            except ValueError:
                raise SystemExit(
                    f"--success-at: expected CM:DEG pairs, got {pair!r}")
        m = rppt.evaluate(cfg, ckpt_dir=args.ckpt_dir or None,
                          step=ckpt_step, per_demo=args.per_demo,
                          percentiles=args.percentiles,
                          success_at=success_at,
                          dump_predictions=args.dump_predictions,
                          drop_cameras=tuple(args.drop_camera),
                          device=args.device)
        print(json.dumps(m, indent=2))
        return 0
    if args.command == "serve":
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.serve import (
            serve,
        )

        httpd, service = serve(cfg, host=args.host, port=args.port,
                               ckpt_dir=args.ckpt_dir or None,
                               step=ckpt_step, max_batch=args.max_batch,
                               warmup=not args.no_warmup,
                               coalesce_ms=args.coalesce_ms,
                               max_body_mb=args.max_body_mb,
                               read_timeout_s=args.read_timeout_s or None,
                               device=args.device)
        print(json.dumps({"serving": f"http://{httpd.server_address[0]}:"
                                     f"{httpd.server_address[1]}",
                          **service.health()}), flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
            service.close()
        return 0
    with _needs("predict"):
        _predict(cfg, args, ckpt_step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
