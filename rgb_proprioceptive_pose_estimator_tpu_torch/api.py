"""Public API of the port: ``train``, ``evaluate``, ``Predictor`` and
``predict`` (counterparts of the JAX package's ``api.py``). Each runs on
CUDA unless asked for the CPU. The CLI over them is ``cli.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import PoseEstimator
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint

Step = Union[int, str, None]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device``, or ``cuda`` when None; raises if CUDA is asked for and
    absent (the port never falls back to the CPU by itself)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def train(cfg: Config, *, device: Union[str, torch.device, None] = None
          ) -> Dict[str, Any]:
    """Train per config (engine/loop.fit) on ``device`` (CUDA by default).
    Returns {"state", "model", "metrics", "ckpt_dir", "ckpt_path"}: the
    final training state and model, the last logged train metrics with the
    last eval's under ``eval_*``, train.ckpt_dir, which
    ``Predictor(cfg, ckpt_dir)`` and ``evaluate(cfg, ckpt_dir)`` restore
    from, and the final checkpoint file.

    With dist.num_devices resolving to N > 1 (0: every visible card),
    the kernels are built here and N processes train data-parallel, one
    per card over NCCL (on the CPU, N processes over gloo); the state and
    model returned are those of the final checkpoint, on ``device``.
    Inside a process group this process trains as its rank."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import fit

    out = fit(cfg, resolve_device(device))
    return {k: out[k] for k in ("state", "model", "metrics", "ckpt_dir",
                                "ckpt_path")}


def load_model(cfg: Config, ckpt_dir: Optional[str] = None, step: Step = None,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[PoseEstimator, int]:
    """(cfg's model with the weights of the checkpoint that ``step`` names
    in ``ckpt_dir`` (default train.ckpt_dir): None the latest, an int that
    step, "best" the one train.ckpt_best_metric kept; in eval mode on
    ``device``, that checkpoint's step)."""
    path, got = checkpoint.resolve(ckpt_dir or cfg.train.ckpt_dir, step)
    return _model_from(cfg, checkpoint.load(path)[1], device), got


def _model_from(cfg: Config, state_dict: Dict[str, torch.Tensor],
                device: Union[str, torch.device, None]) -> PoseEstimator:
    dev = resolve_device(device)
    model = PoseEstimator(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def _eval_drop_cameras(cfg: Config, per_demo: bool,
                       drop_cameras: Sequence[str]) -> Tuple[str, ...]:
    """drop_cameras without repeats, after the JAX package's checks of
    evaluate's per_demo and drop_cameras."""
    if per_demo and cfg.data.source != "hdf5":
        raise ValueError("evaluate(per_demo=True) requires an hdf5 "
                         "data source (demos are HDF5 trajectories)")
    # cli --drop-camera is repeatable: the same name twice must not trip
    # the drop-every-input check
    drop_cameras = tuple(dict.fromkeys(drop_cameras))
    if drop_cameras and cfg.model.backbone == "none":
        raise ValueError(
            "evaluate(drop_cameras=...) is meaningless for a proprio-only "
            "model (model.backbone='none'): there are no camera branches "
            "to kill, the metrics would silently equal the normal eval")
    unknown = [c for c in drop_cameras if c not in cfg.model.cameras]
    if unknown:
        raise ValueError(
            f"evaluate(drop_cameras={unknown}) names cameras not in "
            f"model.cameras={list(cfg.model.cameras)}")
    if drop_cameras and len(drop_cameras) >= len(cfg.model.cameras) \
            and not cfg.model.use_proprio:
        raise ValueError(
            "evaluate(drop_cameras=...) would drop every input: the model "
            "has no proprio branch and all its cameras are listed")
    return drop_cameras


def evaluate(cfg: Config, ckpt_dir: Optional[str] = None, step: Step = None,
             max_batches: int = 0, split: str = "auto",
             data_path: Optional[str] = None, per_demo: bool = False,
             percentiles: bool = False,
             success_at: Sequence[Tuple[float, float]] = (),
             dump_predictions: str = "", drop_cameras: Sequence[str] = (),
             *, device: Union[str, torch.device, None] = None
             ) -> Dict[str, Any]:
    """Restore a checkpoint (``load_model``) and report its eval metrics
    (loss components, pos MAE cm, rot MAE deg, ``step``) over the eval
    pipeline (no augmentation), as the JAX package's ``api.evaluate``.

    split="auto" evaluates the held-out split when data.val_fraction or
    data.val_path is set, else the full dataset; "val" without either
    raises. data_path evaluates another demo file (split "all"). The
    options after it are evaluate_on's.

    With dist.num_devices resolving to N > 1, N launched ranks (as
    ``train`` launches them) each evaluate their slice of every batch of
    ``(min(data.batch_size, samples) // N) * N`` samples, and rank 0's
    report is returned; a split of fewer samples than N is evaluated on
    one device, as the reference falls back to."""
    if data_path is not None:
        cfg = cfg.override(**{"data.path": data_path,
                              "data.source": "hdf5",
                              "data.val_fraction": 0.0,
                              "data.val_path": ""})
        if split == "auto":
            split = "all"
    _eval_drop_cameras(cfg, per_demo, drop_cameras)
    has_val = cfg.data.val_fraction > 0 or bool(cfg.data.val_path)
    if split == "auto":
        split = "val" if has_val else "all"
    if split == "val" and not has_val:
        # a held-out request silently scoring the training set would
        # report training metrics as held-out
        raise ValueError(
            "evaluate(split='val') requires cfg.data.val_fraction > 0 or "
            "data.val_path; with no held-out split use split='all' "
            "(scores the full dataset) or pass data_path= to a held-out "
            "demo file")
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        build_dataset,
    )

    dev = resolve_device(device)
    # a missing checkpoint raises before any data is read
    checkpoint.resolve(ckpt_dir or cfg.train.ckpt_dir, step)
    dataset = build_dataset(cfg, split=split)
    n = dist.resolve_num_devices(cfg, dev)
    kw = dict(max_batches=max_batches, per_demo=per_demo,
              percentiles=percentiles, success_at=success_at,
              dump_predictions=dump_predictions, drop_cameras=drop_cameras)
    if (n > 1 and not dist.is_initialized()
            and min(cfg.data.batch_size, len(dataset)) >= n):
        return dist.launch_ranks(_evaluate_rank, cfg, dev, n, ckpt_dir,
                                 step, split, kw)[0]
    model, got_step = load_model(cfg, ckpt_dir, step, dev)
    return evaluate_on(cfg, model, dataset, step=got_step, **kw)


def _evaluate_rank(cfg: Config, device: torch.device,
                   ckpt_dir: Optional[str], step: Step, split: str,
                   kw: Dict[str, Any]) -> Dict[str, Any]:
    return evaluate(cfg, ckpt_dir, step, split=split, device=device, **kw)


def evaluate_on(cfg: Config, model: PoseEstimator, dataset,
                step: Optional[int] = None, max_batches: int = 0,
                per_demo: bool = False, percentiles: bool = False,
                success_at: Sequence[Tuple[float, float]] = (),
                dump_predictions: str = "",
                drop_cameras: Sequence[str] = ()) -> Dict[str, Any]:
    """evaluate after the restore and the dataset: ``model`` (on its
    device) over ``dataset`` (any object with the datasets' ``__len__`` and
    ``get_batch``), the mean eval metrics over up to ``max_batches``
    batches (0 = one epoch), with ``step`` under "step". On a rank of a
    group of N, each batch of ``(min(data.batch_size, samples) // N) *
    N`` is sharded over the ranks and its metrics averaged over them
    (whole batches on every rank when the split has fewer than N
    samples); the per-sample reports below run on rank 0 alone.

    per_demo (hdf5 datasets) adds "per_demo", each demo's pos/rot MAE and
    length; percentiles adds "pos_err_cm"/"rot_err_deg" p50/p90/p95/max;
    success_at, (cm, deg) pairs, adds "success": per pair the share of
    samples within both and each; dump_predictions writes every sample's
    prediction and error to that .npz and adds "predictions_path". These
    share one per-sample pass over the whole split. drop_cameras are
    scored as dead: absent from the batch, so their encoders do not run
    and they contribute zeroed features.

    With data.device_cache the split's frames are uploaded once (its
    drop_cameras left out) and the batches gather them, each rank its own
    shard under data.cache_layout="sharded" on N > 1; the per-sample pass
    reads pixels."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import (
        evaluate_pipeline,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
        pose_errors,
    )

    drop_cameras = _eval_drop_cameras(cfg, per_demo, drop_cameras)
    device = next(model.parameters()).device
    n = len(dataset)
    if n == 0:
        raise ValueError("the eval split is empty")
    world = dist.world()
    batch_size = (min(cfg.data.batch_size, n) // world) * world
    if batch_size == 0:
        world, batch_size = 1, min(cfg.data.batch_size, n)
    rank = dist.rank() if world > 1 else 0
    use_cache = cfg.data.device_cache and cfg.model.backbone != "none"
    # data.cache_layout="sharded" on N > 1 ranks: each rank holds and
    # gathers from its shard alone (data/cache_shard.py)
    plan = None
    if use_cache and cfg.data.cache_layout == "sharded" and world > 1:
        from rgb_proprioceptive_pose_estimator_tpu_torch.data.cache_shard import (
            build_shard_plan,
        )

        plan = build_shard_plan(dataset.frames_per_demo(), world)
    if use_cache:
        dataset.cache_plan = plan
    pipe = HostPipeline(
        dataset, cfg.data, device=device, train=False,
        batch_size=batch_size, rank=rank, world=world,
        shard_of_sample=(plan.shard_of_sample(dataset.sample_demos())
                         if plan is not None else None),
        n_shards=world if plan is not None else 1)
    try:
        eval_cache = None
        if use_cache:
            from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import (
                upload_image_cache,
            )

            eval_cache = upload_image_cache(
                dataset, cfg.model.image_size, device,
                skip_cameras=drop_cameras, plan=plan, rank=rank)
        out: Dict[str, Any] = evaluate_pipeline(
            model, pipe, cfg, max_batches=max_batches,
            drop_cameras=drop_cameras, image_cache=eval_cache)
    finally:
        pipe.close()
    del eval_cache          # device memory the per-sample pass may need
    out["step"] = step
    if (not (per_demo or percentiles or success_at or dump_predictions)
            or dist.rank() != 0):
        return out

    if dump_predictions and not dump_predictions.endswith(".npz"):
        # np.savez appends it; predictions_path names the file written
        dump_predictions += ".npz"
    out["n_samples"] = n
    pred = Predictor(cfg, model=model, max_batch=min(64, n),
                     allow_missing_cameras=bool(drop_cameras))
    pos_err = np.empty(n, np.float32)
    rot_err = np.empty(n, np.float32)
    dump: Dict[str, np.ndarray] = {
        "pred_pos": np.empty((n, 3), np.float32),
        "pred_quat": np.empty((n, 4), np.float32),
        "target_pos": np.empty((n, 3), np.float32),
        "target_quat": np.empty((n, 4), np.float32),
    } if dump_predictions else {}
    # the per-sample pass takes pixels, not the cache's indices
    emits = getattr(dataset, "emit_image_indices", False)
    dataset.emit_image_indices = False
    for lo in range(0, n, 256):
        idx = np.arange(lo, min(lo + 256, n))
        batch = dataset.get_batch(idx, augment=False, seed=0)
        tpos = np.asarray(batch.pop("target_pos"), np.float32)
        tquat = np.asarray(batch.pop("target_quat"), np.float32)
        for cam in drop_cameras:
            batch["images"].pop(cam)
        pos, quat = pred(batch)
        pe, re_ = pose_errors(*(torch.from_numpy(a)
                                for a in (pos, quat, tpos, tquat)))
        pos_err[idx] = pe.numpy()
        rot_err[idx] = re_.numpy()
        if dump:
            dump["pred_pos"][idx] = pos
            dump["pred_quat"][idx] = quat
            dump["target_pos"][idx] = tpos
            dump["target_quat"][idx] = tquat
    dataset.emit_image_indices = emits

    if dump_predictions:
        dump["pos_err_cm"] = pos_err
        dump["rot_err_deg"] = rot_err
        if hasattr(dataset, "_index"):          # hdf5: trajectory coordinates
            dump["demo_idx"] = dataset._index[:, 0]
            dump["t"] = dataset._index[:, 1]
            dump["demo_keys"] = np.asarray(dataset._demo_keys)
        np.savez(dump_predictions, **dump)
        out["predictions_path"] = dump_predictions

    if percentiles:
        def qtable(err: np.ndarray) -> Dict[str, float]:
            p50, p90, p95 = np.percentile(err, [50, 90, 95])
            return {"p50": round(float(p50), 3), "p90": round(float(p90), 3),
                    "p95": round(float(p95), 3),
                    "max": round(float(err.max()), 3)}

        out["pos_err_cm"] = qtable(pos_err)
        out["rot_err_deg"] = qtable(rot_err)

    if success_at:
        rows = []
        for pos_cm, rot_deg in success_at:
            pos_ok = pos_err <= float(pos_cm)
            rot_ok = rot_err <= float(rot_deg)
            rows.append({"pos_cm": float(pos_cm), "rot_deg": float(rot_deg),
                         "rate": round(float((pos_ok & rot_ok).mean()), 4),
                         "pos_rate": round(float(pos_ok.mean()), 4),
                         "rot_rate": round(float(rot_ok.mean()), 4)})
        out["success"] = rows

    if per_demo:
        demo_ids = dataset._index[:, 0]
        per: Dict[str, Dict[str, float]] = {}
        for di, key in enumerate(dataset._demo_keys):
            mask = demo_ids == di
            per[key] = {"pos_mae_cm": round(float(pos_err[mask].mean()), 3),
                        "rot_mae_deg": round(float(rot_err[mask].mean()), 3),
                        "steps": int(mask.sum())}
        out["per_demo"] = per
    return out


class Predictor:
    """Pose predictor: obs -> (pos, quat).

    Observations may be a single sample (unbatched) or a batch:
        obs["images"][camera]: uint8 (H,W,3) / (T,H,W,3) / (B,[T,]H,W,3)
        obs["proprio"]:        float (D,) / (T,D) / (B,[T,]D)
    Returns float32 numpy (pos, quat) with the batch dim matching the
    input (squeezed for unbatched input). Batches run in chunks of at most
    ``max_batch`` samples.

    Weights come from the checkpoint that ``step`` names in ``ckpt_dir``
    (``load_model``: default the latest in train.ckpt_dir), as in the JAX
    package, unless one of these is given instead: ``model`` (a model
    already built, on its device), ``state`` (a training state,
    engine/state.TrainState, whose model is served, with its EMA's
    weights when it has one), ``state_dict`` (e.g.
    ``utils.convert.state_dict_from_jax``) or ``ckpt_path`` (one
    checkpoint file). ``device`` places what is loaded (CUDA by default).

    A configured camera may be omitted from obs (sensor died) when the
    model trained with model.camera_dropout > 0 or with
    ``allow_missing_cameras=True``: that camera contributes the zeroed
    feature vector and its encoder does not run. Otherwise a missing
    camera raises KeyError.

    ``step`` is the served checkpoint's step (0 for weights that name
    none: ``model``, ``state_dict``), which ``utils/serve.py``'s
    ``/healthz`` reports.
    """

    def __init__(self, cfg: Config, ckpt_dir: Optional[str] = None,
                 step: Step = None, max_batch: int = 8, state=None,
                 model: Optional[PoseEstimator] = None,
                 allow_missing_cameras: bool = False, *,
                 ckpt_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device: Union[str, torch.device, None] = None):
        if state is not None:
            if model is not None and model is not state.model:
                raise ValueError("state and model name different models")
            model = state.model
        given = [k for k, v in (("ckpt_path", ckpt_path),
                                ("state_dict", state_dict),
                                ("model or state", model))
                 if v is not None]
        if len(given) > 1 or (given and (ckpt_dir is not None
                                         or step is not None)):
            raise ValueError("pass at most one of ckpt_path, state_dict and "
                             "model (or state), and ckpt_dir/step only "
                             "without them")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cfg = cfg
        self.step = 0 if state is None else int(state.step)
        if state is not None and state.ema is not None:
            # the weights the state serves: its EMA's
            state_dict, model = state.serving_state_dict(), None
            device = device or next(state.model.parameters()).device
        if ckpt_path is not None:
            _, weights, training = checkpoint.load_training(ckpt_path)
            state_dict = checkpoint.served(weights, training)
            self.step = int((training or {}).get("step", 0))
        if state_dict is not None:
            model = _model_from(cfg, state_dict, device)
        elif model is None:
            model, self.step = load_model(cfg, ckpt_dir, step, device)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.max_batch = max_batch
        self.allow_missing_cameras = (allow_missing_cameras
                                      or cfg.model.camera_dropout > 0)

    def _batched(self, obs: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], int, bool]:
        m = self.cfg.model
        cameras = self.model.cameras
        present = [c for c in cameras if c in obs.get("images", {})]
        missing = [c for c in cameras if c not in present]
        if missing and not self.allow_missing_cameras:
            raise KeyError(
                f"obs['images'] is missing cameras {missing} of "
                f"model.cameras={list(m.cameras)}. If the sensor really is "
                "dead, train with model.camera_dropout > 0 (the model then "
                "serves the failure gracefully) or pass "
                "Predictor(..., allow_missing_cameras=True) to accept the "
                "out-of-distribution degradation; if this is a typo'd "
                "camera key, fix the obs dict")
        if not present and not m.use_proprio:
            raise ValueError(
                f"obs supplies none of the model's cameras "
                f"{list(m.cameras)} and the model has no proprio branch")
        # unbatched input is told apart by the proprio or image rank
        if m.use_proprio:
            p = np.asarray(obs["proprio"], dtype=np.float32)
            unbatched = p.ndim == (1 if m.temporal_frames == 1 else 2)
        else:
            img = np.asarray(obs["images"][present[0]])
            unbatched = img.ndim == (3 if m.temporal_frames == 1 else 4)

        def prep(x, dtype):
            x = np.ascontiguousarray(np.asarray(x, dtype=dtype))
            return x[None] if unbatched else x

        batch: Dict[str, Any] = {}
        n = 0
        if m.use_proprio:
            batch["proprio"] = prep(obs["proprio"], np.float32)
            n = batch["proprio"].shape[0]
        batch["images"] = {c: prep(obs["images"][c], np.uint8)
                           for c in present}
        if present:
            n = batch["images"][present[0]].shape[0]
        return batch, n, unbatched

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def warmup(self, dead_camera_sets: Sequence[Sequence[str]] = ()
               ) -> "Predictor":
        """Run one zeroed max_batch call end to end, so the kernels are
        built and loaded and the first real call pays none of that.

        dead_camera_sets: also run each set of cameras omitted (a
        dead-camera signature a robust stack may meet mid-run, such as
        every single failure of a dual-camera model), so that the first
        call after a sensor dies pays no first-call cost either. Needs a
        model that accepts missing cameras (model.camera_dropout, or
        allow_missing_cameras=True). Returns self for chaining."""
        m = self.cfg.model
        t = (m.temporal_frames,) if m.temporal_frames > 1 else ()
        obs: Dict[str, Any] = {}
        if m.backbone != "none":
            hw = (m.image_size, m.image_size, 3)
            obs["images"] = {
                c: np.zeros((self.max_batch, *t, *hw), np.uint8)
                for c in m.cameras}
        if m.use_proprio:
            obs["proprio"] = np.zeros(
                (self.max_batch, *t, m.proprio_dim), np.float32)
        self(obs)
        for dead in dead_camera_sets:
            dead = set(dead)
            unknown = dead - set(m.cameras)
            if unknown:
                raise ValueError(
                    f"warmup(dead_camera_sets=...): {sorted(unknown)} not "
                    f"in model.cameras={list(m.cameras)}")
            dobs = dict(obs)
            dobs["images"] = {c: v for c, v in obs.get("images", {}).items()
                              if c not in dead}
            self(dobs)
        return self

    def __call__(self, obs: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        batch, n, unbatched = self._batched(obs)
        pos_parts, quat_parts = [], []
        with torch.inference_mode():
            for lo in range(0, n, self.max_batch):
                hi = lo + self.max_batch
                chunk: Dict[str, Any] = {"images": {
                    c: self._to_device(v[lo:hi])
                    for c, v in batch["images"].items()}}
                if "proprio" in batch:
                    chunk["proprio"] = self._to_device(batch["proprio"][lo:hi])
                p, q = self.model(chunk)
                pos_parts.append(p.float().cpu().numpy())
                quat_parts.append(q.float().cpu().numpy())
        pos = np.concatenate(pos_parts)
        quat = np.concatenate(quat_parts)
        if unbatched:
            pos, quat = pos[0], quat[0]
        return pos, quat


def predict(cfg: Config, obs: Dict[str, Any], ckpt_dir: Optional[str] = None,
            step: Step = None, *, ckpt_path: Optional[str] = None,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot convenience wrapper; use ``Predictor`` for repeated calls."""
    return Predictor(cfg, ckpt_dir, step, ckpt_path=ckpt_path,
                     device=device)(obs)
