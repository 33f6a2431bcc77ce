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

``train``, ``eval``, ``predict`` and ``serve`` run on ``--device``
(default cuda; ``--device cpu`` runs the kernels' plain versions on the
CPU); ``train`` and ``eval`` with ``dist.num_devices`` resolving to N > 1
run N data-parallel processes, one per card (``api.train``,
``api.evaluate``). ``serve`` is the HTTP pose server (utils/serve.py),
the JAX package's wire protocol. ``info`` prints the reference's report,
and on stderr the device count that ``dist.num_devices`` resolves to.
``export``, ``render``, ``repack``, ``sweep``, ``curves`` and
``inspect`` are not in the port yet: they exit with status 2, naming
ROADMAP.md queue A item 11.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    PRESETS,
    Config,
    preset,
)

PORTED = ("train", "eval", "predict", "serve", "config", "presets", "info")
LATER = ("export", "render", "repack", "sweep", "curves", "inspect")


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
    if args.plot:
        raise SystemExit("predict --plot: the trajectory figure is not in "
                         "the port yet (ROADMAP.md queue A, item 11)")
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
    print(json.dumps({"pos_mae_cm": round(float(m["pos_mae_cm"]), 3),
                      "rot_mae_deg": round(float(m["rot_mae_deg"]), 3)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rppt")
    ap.add_argument("command", choices=PORTED + LATER)
    ap.add_argument("--preset", default="pr1", choices=sorted(PRESETS))
    ap.add_argument("--config", default="", help="JSON config file")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="dotted config override, repeatable")
    ap.add_argument("--device", default="cuda",
                    help="train/eval/predict/serve: torch device (cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default="", help="eval/predict: checkpoint dir")
    ap.add_argument("--step", default="0",
                    help="eval/predict: checkpoint step (0 = latest; 'best' "
                         "= the train.ckpt_best_metric checkpoint under "
                         "<ckpt_dir>/best)")
    ap.add_argument("--demo", type=int, default=0,
                    help="predict: demo index in data.path")
    ap.add_argument("--t", type=int, default=-1,
                    help="predict: timestep (-1 = all steps of the demo)")
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
                    help="predict: trajectory figure (not in the port yet)")
    ap.add_argument("--dump-predictions", default="", metavar="NPZ",
                    help="eval: write every per-sample prediction to an npz")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="serve: the Predictor's largest batch per call")
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
    # the subcommands not in the port yet take the JAX CLI's other flags;
    # they are refused before those are read
    args, rest = ap.parse_known_args(argv)
    if args.command in LATER:
        print(f"{args.command}: not in the port yet (ROADMAP.md queue A, "
              "item 11); the JAX package's CLI has it", file=sys.stderr)
        return 2
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

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
    _predict(cfg, args, ckpt_step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
