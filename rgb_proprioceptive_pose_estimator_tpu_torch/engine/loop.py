"""The training loop (counterpart of the JAX package's
``engine/loop.py``), on one device or data-parallel on several.

``fit(cfg, device)`` builds the datasets and a fresh state and hands them
to ``train_on``, which does everything after: proprio statistics from the
train split, resume from ``train.ckpt_dir`` (``train.resume``: the latest
checkpoint, none, or an explicit step; model, optimizer, step and sampler
state), the train and eval pipelines, the steps in calls of
``train.steps_per_call`` (a plain loop with the JAX package's cadence
checks), log, eval and checkpoint cadences, the best-eval checkpoint
(``train.ckpt_best_metric``), save on SIGTERM, and the final checkpoint.

The reference's training extras: warm starts from another run
(``train.init_from``) or from torchvision ResNet weights
(``train.init_from_torch``), both only while ``ckpt_dir`` holds no
checkpoint; the EMA of the parameters, which every eval and the best and
final checkpoints serve, with BatchNorm statistics recalibrated for it
(``train.ema_bn_recal_batches``) before each eval and the final save;
``train.grad_accum`` (``train.steps`` and the cadences count micro-steps,
as in the reference); early stopping on the eval metric
(``train.early_stop_patience``); ``train.debug_nans``; and a profiler
trace window (``train.profile_dir``).

With ``dist.num_devices`` resolving to N > 1 (``parallel/dist.py``: 0
means every visible card), ``fit`` launches N processes, one per device,
each running ``fit`` as a rank of the group, and returns rank 0's result;
a process that is already a rank (under ``torchrun``, say) runs as one.
Under ``dist.multihost`` each host's ``fit`` launches its own ranks of
the one group (``dist.launch_host``) and returns the final checkpoint's
state. On a rank, ``train_on`` wraps the model in DistributedDataParallel,
feeds it its slice of each global batch, averages the logged and eval
metrics over the ranks, stops every rank at the same step on SIGTERM or
early stopping, and lets rank 0 alone write checkpoints and metrics. The
global batch must divide by N; ``bn_stats="pallas"`` is refused on N > 1
as in the reference.

The device-resident data path: with ``data.device_cache`` the resized
uint8 frames of the train split (at ``image_size + 2*crop_margin`` under
``data.augment_device``) and of the eval split are uploaded to the device
once (``upload_image_cache``, refused before allocating when they exceed
``device_cache_budget``), the pipelines send int32 frame indices, and the
steps gather the frames; ``data.cache_layout="sharded"`` gives each rank
only its shard of the frames (data/cache_shard.py). With
``data.augment_device`` crop, flip and jitter run in the step on the
device (engine/train_step.prepare_batch), in BN recalibration too.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    TrainState,
    create_state,
    ema_of,
    serving,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    device_aug_of,
    eval_step,
    gather_cached_images,
    recalibrate_batch_stats,
    train_step,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    BatchNormAct,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.metrics import MetricsLogger
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.prof import TraceWindow


def device_cache_budget() -> int:
    """Device memory (bytes) the frame cache may take: 3/4 of the card's
    (torch.cuda.mem_get_info's total), leaving the rest for the model,
    the optimizer and the activations, which this guard does not count;
    12 GB without a card."""
    if torch.cuda.is_available():
        return (torch.cuda.mem_get_info()[1] * 3) // 4
    return 12 * 1024 ** 3


def upload_image_cache(store, hw: int, device: torch.device,
                       budget_bytes: int = 0, skip_cameras=(), plan=None,
                       rank: int = 0) -> Dict[str, torch.Tensor]:
    """data.device_cache: the store's deterministic resize cache at
    ``hw``, {camera: (rows, hw, hw, 3) uint8} on ``device``. Raises
    ValueError, before anything is allocated on the device, when it
    exceeds ``budget_bytes`` (default ``device_cache_budget()``).

    skip_cameras: cameras left out of the upload and the budget
    (evaluate's drop_cameras, scored dead; the gather then never makes
    them).

    plan (data/cache_shard.CacheShardPlan, data.cache_layout="sharded"):
    rank ``rank`` uploads and budgets only its shard, rows [rank*S,
    (rank+1)*S) of the plan's shard-contiguous layout, which the indices
    that the store emits under the plan address. Default: every frame."""
    skip = set(skip_cameras)
    base = store.build_resized_cache(hw)
    rows = None
    if plan is not None:
        s = plan.rows_per_shard
        rows = plan.frame_of_row[rank * s:(rank + 1) * s]
    arrs = {c: (a if rows is None else a[rows]) for c, a in base.items()
            if c not in skip}
    per_device = sum(a.nbytes for a in arrs.values())
    budget = budget_bytes or device_cache_budget()
    if per_device > budget:
        raise ValueError(
            f"data.device_cache: resized frames need {per_device / 1e9:.1f} "
            f"GB of device memory per device > {budget / 1e9:.1f} GB budget "
            "(75% of device capacity; excludes model/optimizer/activation "
            "memory); "
            + ("use the host pipeline for datasets this size" if plan
               else "try data.cache_layout='sharded' on several devices, "
                    "or the host pipeline"))
    return {c: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for c, a in arrs.items()}


def evaluate_pipeline(model: torch.nn.Module, pipeline: HostPipeline,
                      cfg: Config, max_batches: int = 0, start: int = 0,
                      drop_cameras: Sequence[str] = (),
                      image_cache: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, float]:
    """Average eval metrics over (up to) one epoch; ``start`` rotates
    partial passes across the split (HostPipeline.epoch). ``drop_cameras``
    are removed from every batch: scored as dead sensors. Batches of
    frame indices gather from ``image_cache``. A pipeline of a rank's
    slices gives each global batch's metrics, averaged over the ranks."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in pipeline.epoch(max_batches=max_batches, start=start):
        if image_cache is not None and "image_idx" in batch:
            batch = gather_cached_images(image_cache, batch)
        if drop_cameras:
            batch = dict(batch, images={k: v for k, v in
                                        batch["images"].items()
                                        if k not in drop_cameras})
        m = eval_step(model, batch, cfg.train)
        if pipeline.world > 1:
            m = dist.mean(m)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def check_fit_supported(cfg: Config, n_dev: int = 1) -> None:
    """Raise ValueError, as the reference's fit does, for a global batch
    that ``n_dev`` devices do not divide, for ``bn_stats="pallas"`` on
    more than one, for early stopping without evals and for both warm
    starts at once. The config itself refuses data.device_cache with
    host augmentation or a non-hdf5 source, and a sharded layout without
    the cache."""
    t, m, d = cfg.train, cfg.model, cfg.data
    dist.check_multihost(cfg)
    if d.batch_size % n_dev != 0:
        raise ValueError(
            f"global batch {d.batch_size} not divisible by {n_dev} devices")
    if m.bn_stats == "pallas" and n_dev > 1:
        # the one-pass statistics kernel (ops/fused.channel_stats) sums one
        # rank's rows: on a sharded batch its statistics would be the
        # rank's, not the global batch's
        raise ValueError(
            f"model.bn_stats='pallas' is single-device only (got "
            f"{n_dev}-device mesh): pallas_call cannot partition the batch "
            "reduction. Use bn_stats='matmul' (SPMD-safe, MXU-routed) or "
            "'reduce' (default) on multi-device meshes.")
    if t.early_stop_patience and not t.eval_every:
        raise ValueError(
            "train.early_stop_patience requires train.eval_every > 0 "
            "(patience counts evaluations)")
    if t.init_from and t.init_from_torch:
        raise ValueError(
            "train.init_from and train.init_from_torch are mutually "
            "exclusive: a full-run warm start already carries its own "
            "backbone weights")


def fit(cfg: Config, device: torch.device) -> Dict[str, Any]:
    """Train per cfg on ``device`` from freshly initialized weights (seed
    train.seed), or from the checkpoint in train.ckpt_dir that
    train.resume names; returns train_on's result.

    When dist.num_devices resolves to N > 1 and this process is not a rank
    yet, N ranks are launched, on cuda:0 .. N-1 over "nccl" (on the CPU N
    times over "gloo"); under dist.multihost this host's ranks of the
    group. The result holds the metrics of this host's first rank, and
    the state and model of the final checkpoint on ``device``."""
    device = torch.device(device)
    n = dist.resolve_num_devices(cfg, device)
    check_fit_supported(cfg, n)
    if n > 1 and not dist.is_initialized():
        out = dist.launch_ranks(fit_rank, cfg, device, n)[0]
        return restore_final(cfg, device, out["metrics"], out["ckpt_path"])
    has_val = cfg.data.val_fraction > 0 or bool(cfg.data.val_path)
    dataset = build_dataset(cfg, split="train" if has_val else "all")
    eval_ds = build_dataset(cfg, split="val") if has_val else dataset
    state = create_state(cfg, device)
    return train_on(cfg, state, dataset, eval_ds)


def fit_rank(cfg: Config, device: torch.device) -> Dict[str, Any]:
    """fit on this rank of a launched group (``dist.launch``'s target);
    returns what a rank sends back: its metrics and the path of the final
    checkpoint."""
    out = fit(cfg, device)
    return {"metrics": out["metrics"], "ckpt_path": out["ckpt_path"]}


def restore_training(state: TrainState, path: str, ema_on: bool
                     ) -> Dict[str, Any]:
    """Load the checkpoint at ``path`` into ``state``: model, optimizer,
    step and EMA, by the reference's rule for an EMA switched on or off
    since the checkpoint was written (on: one the checkpoint lacks starts
    at its parameters; off: the checkpoint's is dropped). Returns the
    checkpoint's training state."""
    _, state_dict, training = checkpoint.load_training(path)
    if "optimizer" not in (training or {}):
        raise ValueError(
            f"{path} holds no optimizer state (a serving checkpoint, such "
            "as scripts/torch_from_orbax.py writes): a run does not resume "
            "from it; warm-start with train.init_from=<its directory>")
    state.model.load_state_dict(state_dict, strict=True)
    state.optimizer.load_state_dict(training["optimizer"])
    state.step = int(training["step"])
    ema = training.get("ema")
    if not ema_on:
        state.ema = None
    elif ema is None:
        state.ema = ema_of(state.model)
    else:
        state.ema = {k: v.to(state.model.pose_out.weight.device)
                     for k, v in ema.items()}
    return training


def restore_final(cfg: Config, device: torch.device,
                  metrics: Dict[str, float], ckpt_path: Optional[str]
                  ) -> Dict[str, Any]:
    """What fit returns, for launched ranks that returned ``metrics`` and
    the final checkpoint ``ckpt_path``: the state and model of that
    checkpoint, restored on ``device`` (a fresh state when None)."""
    state = create_state(cfg, device)
    if ckpt_path is not None:
        restore_training(state, ckpt_path, cfg.train.ema_decay > 0)
    return {"state": state, "model": state.model, "metrics": metrics,
            "ckpt_dir": cfg.train.ckpt_dir, "ckpt_path": ckpt_path}


def warm_start(cfg: Config, state: TrainState) -> None:
    """train.init_from: the weights another run serves (its EMA's
    parameters where it kept one, else its raw ones) and all its
    buffers, BatchNorm and proprio statistics included, from the latest
    checkpoint of that directory (or ``.../best``); the optimizer, step
    and data order stay fresh. train.init_from_torch: torchvision ResNet
    or VisionTransformer weights into every camera encoder. Either way
    the EMA restarts at the imported weights."""
    tcfg, model = cfg.train, state.model
    if tcfg.init_from:
        path, _ = checkpoint.resolve(tcfg.init_from)
        _, weights = checkpoint.load(path)
        target = model.state_dict()
        missing = sorted(set(target) - set(weights))[:4]
        extra = sorted(set(weights) - set(target))[:4]
        if missing or extra:
            raise ValueError(
                f"train.init_from: checkpoint tree does not match the model "
                f"(missing from checkpoint: {missing}; not in model: "
                f"{extra}) -- the source run used a different model config")
        for k, v in weights.items():
            if v.shape != target[k].shape:
                raise ValueError(
                    f"train.init_from: {k} shape {tuple(v.shape)} in the "
                    f"checkpoint vs {tuple(target[k].shape)} in the model "
                    "-- the source run used a different model config")
        model.load_state_dict(weights, strict=True)
    else:
        from rgb_proprioceptive_pose_estimator_tpu_torch.utils.torch_import import (
            load_pretrained_backbone,
            load_state_dict_file,
        )

        arch = cfg.model.backbone
        if arch not in ("resnet18", "resnet34", "resnet50", "vit"):
            raise ValueError(
                f"train.init_from_torch: no torchvision import mapping for "
                f"model.backbone={arch!r} (supported: resnet18/resnet34/"
                "resnet50/vit)")
        if arch == "vit" and cfg.model.vit_pool != "cls":
            raise ValueError(
                "train.init_from_torch with a ViT backbone requires "
                "model.vit_pool='cls' (torchvision VisionTransformer reads "
                "the class token; mean pooling would misuse the imported "
                "pos_embed CLS slot)")
        sd = load_state_dict_file(tcfg.init_from_torch)
        for cam in cfg.model.cameras:
            load_pretrained_backbone(model, cam, sd, arch,
                                     depth=cfg.model.vit_depth,
                                     heads=cfg.model.vit_heads)
    if state.ema is not None:
        state.ema = ema_of(model)


def _check_cadence(cfg: Config) -> int:
    """train.steps_per_call, after the JAX package's multiple-of checks."""
    tcfg = cfg.train
    spc = max(tcfg.steps_per_call, 1)
    if spc > 1:
        for name, v in (("log_every", tcfg.log_every),
                        ("eval_every", tcfg.eval_every),
                        ("ckpt_every", tcfg.ckpt_every),
                        ("steps", tcfg.steps)):
            if v and v % spc != 0:
                raise ValueError(
                    f"train.{name}={v} must be a multiple of "
                    f"train.steps_per_call={spc}")
    return spc


def _resume_step(cfg: Config) -> Optional[int]:
    """The step train.resume takes up in train.ckpt_dir: None for a fresh
    run, else the latest checkpoint's ("auto") or the explicit one."""
    tcfg = cfg.train
    saved = checkpoint.steps(tcfg.ckpt_dir)
    if tcfg.resume not in ("auto", "none") and not saved:
        raise FileNotFoundError(
            f"train.resume={tcfg.resume!r} but {tcfg.ckpt_dir} contains no "
            "checkpoint")
    if not saved:
        return None
    if tcfg.resume == "none":
        # interleaving a fresh run into an existing history would
        # overwrite it step by step
        raise ValueError(
            f"train.resume='none' but {tcfg.ckpt_dir} already contains a "
            f"checkpoint at step {saved[-1]}; use a fresh ckpt_dir or "
            "resume='auto'")
    return saved[-1] if tcfg.resume == "auto" else int(tcfg.resume)


def train_on(cfg: Config, state: TrainState, dataset, eval_ds
             ) -> Dict[str, Any]:
    """Train ``state`` on ``dataset`` (any object with the datasets'
    ``__len__``, ``get_batch`` and ``proprio_stats``; with
    data.device_cache also the store's ``build_resized_cache``,
    ``frames_per_demo``, ``sample_demos``, ``emit_image_indices`` and
    ``cache_plan``) for train.steps,
    evaluating on ``eval_ds``. Returns {state, model, metrics, ckpt_dir,
    ckpt_path}: the last logged train metrics with the last eval's under
    ``eval_*``, and the final checkpoint's path."""
    model = state.model
    device = next(model.parameters()).device
    world, rank = dist.world(), dist.rank()
    n = dist.resolve_num_devices(cfg, device)
    if n != world:
        raise ValueError(
            f"dist.num_devices={cfg.dist.num_devices} asks for {n} devices "
            f"and this process runs {world}: fit launches one process per "
            "device; set dist.num_devices=1 to train here alone")
    check_fit_supported(cfg, world)
    tcfg = cfg.train
    spc = _check_cadence(cfg)
    if tcfg.ckpt_best_metric and not tcfg.eval_every:
        raise ValueError(
            "train.ckpt_best_metric requires train.eval_every > 0 "
            "(best tracking selects on eval metrics)")
    resume = _resume_step(cfg)

    if cfg.model.use_proprio and cfg.model.proprio_normalize:
        # train-split obs-normalization statistics into the model buffers;
        # a resumed run's checkpoint or a warm start overwrites them below,
        # so the weights keep the statistics they were trained with
        mean, std = dataset.proprio_stats()
        with torch.no_grad():
            model.proprio.proprio_mean.copy_(torch.from_numpy(mean))
            model.proprio.proprio_std.copy_(torch.from_numpy(std))

    start_step = 0
    best_val = float("inf")
    ckpt_path: Optional[str] = None
    if resume is None and (tcfg.init_from or tcfg.init_from_torch):
        # only while this run has no checkpoint of its own: a preempted
        # run resumes its own state
        warm_start(cfg, state)
    if resume is not None:
        ckpt_path, _ = checkpoint.resolve(tcfg.ckpt_dir, resume)
        training = restore_training(state, ckpt_path, tcfg.ema_decay > 0)
        start_step = state.step
        best_dir = os.path.join(tcfg.ckpt_dir, checkpoint.BEST)
        if tcfg.ckpt_best_metric and checkpoint.steps(best_dir):
            # the best so far, so that a worse eval after the resume does
            # not replace the true best
            best = checkpoint.load_training(checkpoint.resolve(best_dir)[0])
            best_val = float(best[2].get("best_val", best_val))
    if spc > 1 and (tcfg.steps - start_step) % spc != 0:
        raise ValueError(
            f"resume step {start_step} leaves {tcfg.steps - start_step} "
            f"steps, not a multiple of train.steps_per_call={spc}")

    if world > 1 and state.ddp is None:
        state.ddp = dist.data_parallel(model)
    # data.cache_layout="sharded": the plans exist before the pipelines
    # (the sampler gives rank d shard d's samples) and before the stores
    # emit indices (rows of the rank's shard)
    use_cache = (cfg.data.device_cache and cfg.model.backbone != "none"
                 and cfg.data.source == "hdf5")
    sharded = use_cache and cfg.data.cache_layout == "sharded"
    train_plan = eval_plan = None
    if sharded:
        from rgb_proprioceptive_pose_estimator_tpu_torch.data.cache_shard import (
            build_shard_plan,
        )

        train_plan = build_shard_plan(dataset.frames_per_demo(), world)
        eval_plan = (train_plan if eval_ds is dataset
                     else build_shard_plan(eval_ds.frames_per_demo(), world))
    if use_cache:
        dataset.cache_plan = train_plan
        eval_ds.cache_plan = eval_plan

    def shard_args(ds, plan) -> Dict[str, Any]:
        if plan is None:
            return {}
        return {"shard_of_sample": plan.shard_of_sample(ds.sample_demos()),
                "n_shards": world}

    train_pipe = HostPipeline(dataset, cfg.data, device=device, train=True,
                              rank=rank, world=world,
                              **shard_args(dataset, train_plan))
    if resume is not None:
        train_pipe.load_state_dict(training["pipeline"])
    # the eval batch shrinks to a small held-out split, still a multiple
    # of the device count
    eval_bs = min(cfg.data.batch_size, (len(eval_ds) // world) * world)
    if eval_bs == 0:
        raise ValueError(
            f"val split has {len(eval_ds)} samples < {world} devices; "
            "increase data.val_fraction or reduce dist.num_devices")
    eval_pipe = HostPipeline(eval_ds, cfg.data, device=device, train=False,
                             batch_size=eval_bs, rank=rank, world=world,
                             **shard_args(eval_ds, eval_plan))
    device_aug = device_aug_of(cfg)
    train_cache = eval_cache = None
    if use_cache:
        hw_train = (cfg.model.image_size + 2 * cfg.data.crop_margin
                    if device_aug is not None else cfg.model.image_size)
        train_cache = upload_image_cache(dataset, hw_train, device,
                                         plan=train_plan, rank=rank)
        if eval_ds is dataset and hw_train == cfg.model.image_size:
            eval_cache = train_cache
        else:
            eval_cache = upload_image_cache(eval_ds, cfg.model.image_size,
                                            device, plan=eval_plan,
                                            rank=rank)
    schedule = state.optimizer.schedule
    metrics_path = tcfg.metrics_path or f"{tcfg.ckpt_dir}/metrics.jsonl"
    # rank 0 writes the metrics, as it writes the checkpoints
    logger = MetricsLogger(metrics_path if rank == 0 else "",
                           tensorboard=tcfg.tensorboard and rank == 0,
                           tb_dir=tcfg.ckpt_dir)

    def training_state(**extra) -> Dict[str, Any]:
        # mid-accumulation under DDP the ranks' gradient sums differ: one
        # file holds their mean (collective, so before rank 0 alone writes)
        state.optimizer.average_accumulator()
        out = {"step": state.step, "optimizer": state.optimizer.state_dict(),
               "pipeline": train_pipe.state_dict(), **extra}
        if state.ema is not None:
            out["ema"] = state.ema
        return out

    def save(step: int) -> str:
        # a step saved by an earlier run (an explicit-step resume re-walks
        # them) is replaced; rank 0 writes, and no rank goes on before
        path = checkpoint.save_step(tcfg.ckpt_dir, step, tcfg.ckpt_keep, cfg,
                                    model.state_dict(), training_state())
        dist.barrier()
        return path

    def recalibrated() -> Optional[Dict[str, torch.Tensor]]:
        """BatchNorm statistics for the served weights, from
        train.ema_bn_recal_batches train-pipeline batches (consumed, as
        in the reference), or None when it is off."""
        if not (tcfg.ema_bn_recal_batches and has_stats):
            return None
        with serving(model, state.ema):
            return recalibrate_batch_stats(
                model, (next(train_pipe)
                        for _ in range(tcfg.ema_bn_recal_batches)),
                tcfg.seed, train_cache, device_aug,
                momentum=cfg.model.bn_momentum)

    # as the reference: whenever the model has statistics (BatchNorm's, or
    # proprio normalization's, which a train-mode forward leaves as they
    # are) recalibration runs, and consumes its batches
    has_stats = (any(isinstance(m, BatchNormAct) for m in model.modules())
                 or (cfg.model.use_proprio and cfg.model.proprio_normalize))
    tracer = TraceWindow(tcfg.profile_dir, tcfg.profile_start,
                         tcfg.profile_steps, device, rank)

    # save on SIGTERM (train.save_on_signal): finish the step in flight,
    # checkpoint it and return; only from the main thread, where Python
    # allows signal handlers
    preempt_signum: Optional[int] = None

    def _on_sigterm(signum, frame):
        nonlocal preempt_signum
        preempt_signum = signum

    sig_installed = (tcfg.save_on_signal and threading.current_thread()
                     is threading.main_thread())
    prev_sigterm = (signal.signal(signal.SIGTERM, _on_sigterm)
                    if sig_installed else None)

    last_metrics: Dict[str, float] = {}
    last_saved: Optional[int] = None
    final_step = tcfg.steps
    preempted = False
    # early stopping: consecutive evals without a > min_delta improvement
    # of the metric (train.ckpt_best_metric, else the eval loss); in-run
    # state only, as in the reference
    es_metric = tcfg.ckpt_best_metric or "loss"
    es_best = float("inf")
    es_stale = 0
    stopped_at: Optional[int] = None
    accum = max(tcfg.grad_accum, 1)
    log_anchor = start_step
    t_log = time.perf_counter()
    try:
        for step_i in range(start_step, tcfg.steps, spc):
            for _ in range(spc):
                m = train_step(state, next(train_pipe), tcfg, train_cache,
                               device_aug)
            step1 = step_i + spc
            tracer.on_step(step1)
            if step_i == start_step and tcfg.log_every > 1:
                # keep the first call (kernel builds, cuDNN plans) out of
                # the first throughput window
                float(m["loss"])
                t_log = time.perf_counter()
                log_anchor = step1
            if step1 % tcfg.log_every == 0 or step1 == tcfg.steps:
                vals = {k: float(v) for k, v in m.items()}   # syncs
                now = time.perf_counter()
                dt = now - t_log
                t_log = now
                imgs = cfg.data.batch_size * max(step1 - log_anchor, 1)
                log_anchor = step1
                last_metrics = dict(vals)
                last_metrics.update({
                    "images_per_sec": imgs / dt,
                    "images_per_sec_per_chip": imgs / dt / world,
                    "host_queue_depth": train_pipe.queue_depth(),
                    "lr": float(schedule(step1 // accum)),
                })
                logger.log(step1, last_metrics, prefix="train/")
            if tcfg.eval_every and (step1 % tcfg.eval_every == 0
                                    or step1 == tcfg.steps):
                eval_start = (step1 // tcfg.eval_every) * max(tcfg.eval_steps,
                                                              0)
                stats = recalibrated()
                with serving(model, state.ema, stats):
                    em = evaluate_pipeline(model, eval_pipe, cfg,
                                           max_batches=tcfg.eval_steps,
                                           start=eval_start,
                                           image_cache=eval_cache)
                logger.log(step1, em, prefix="eval/")
                last_metrics.update({f"eval_{k}": v for k, v in em.items()})
                if tcfg.ckpt_best_metric:
                    v = em.get(tcfg.ckpt_best_metric)
                    if v is None:
                        raise KeyError(
                            f"ckpt_best_metric {tcfg.ckpt_best_metric!r} "
                            f"not in eval metrics {sorted(em)}")
                    if v < best_val:
                        best_val = v
                        # with recalibration the best checkpoint ships the
                        # statistics matched to the weights it serves
                        checkpoint.save_best(
                            tcfg.ckpt_dir, step1, cfg,
                            {**model.state_dict(), **(stats or {})},
                            training_state(best_val=float(v)))
                        dist.barrier()
                if tcfg.early_stop_patience:
                    v = em.get(es_metric)
                    if v is None:
                        raise KeyError(
                            f"early-stop metric {es_metric!r} not in eval "
                            f"metrics {sorted(em)}")
                    if float(v) < es_best - tcfg.early_stop_min_delta:
                        es_best, es_stale = float(v), 0
                    else:
                        es_stale += 1
                        if es_stale >= tcfg.early_stop_patience:
                            stopped_at = step1
                # eval time is not train throughput
                t_log = time.perf_counter()
                log_anchor = step1
            if tcfg.ckpt_every and step1 % tcfg.ckpt_every == 0:
                ckpt_path = save(step1)
                last_saved = step1
            if stopped_at is not None:
                # the eval metrics are the ranks' mean: every rank stops
                final_step = stopped_at
                last_metrics["early_stopped_at"] = float(stopped_at)
                break
            # every rank stops at the same step when any received it
            if dist.any_rank(preempt_signum is not None):
                final_step = step1
                preempted = True
                last_metrics["preempted_at"] = float(step1)
                logger.log(step1, {"preempted_at": float(step1)},
                           prefix="train/")
                break
        tracer.close()
        # the final checkpoint serves BatchNorm statistics recalibrated for
        # its weights, which the state keeps from here (not on preemption:
        # that checkpoint is a resume point); nothing to save when a
        # finished run is run again
        if start_step < final_step:
            stats = None if preempted else recalibrated()
            if stats is not None:
                with torch.no_grad():
                    for k, v in model.state_dict().items():
                        if k in stats:
                            v.copy_(stats[k])
            if stats is not None or last_saved != final_step:
                ckpt_path = save(final_step)
        logger.close()
        train_pipe.close()
        eval_pipe.close()
    finally:
        if sig_installed:
            signal.signal(signal.SIGTERM, prev_sigterm)
    return {"state": state, "model": model, "metrics": last_metrics,
            "ckpt_dir": tcfg.ckpt_dir, "ckpt_path": ckpt_path}
