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

With ``dist.num_devices`` resolving to N > 1 (``parallel/dist.py``: 0
means every visible card), ``fit`` launches N processes, one per device,
each running ``fit`` as a rank of the group, and returns rank 0's result;
a process that is already a rank (under ``torchrun``, say) runs as one.
On a rank, ``train_on`` wraps the model in DistributedDataParallel, feeds
it its slice of each global batch, averages the logged and eval metrics
over the ranks, stops every rank at the same step on SIGTERM, and lets
rank 0 alone write checkpoints and metrics. The global batch must divide
by N; ``bn_stats="pallas"`` is refused on N > 1 as in the reference.

Not in the port yet, and refused rather than ignored
(``check_fit_supported``): warm starts, early stopping, EMA and the other
training extras (ROADMAP.md queue A, item 9); training across hosts
(item 8g).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Dict, Optional, Sequence

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
    HostPipeline,
    build_dataset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    TrainState,
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    eval_step,
    train_step,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.metrics import MetricsLogger


def evaluate_pipeline(model: torch.nn.Module, pipeline: HostPipeline,
                      cfg: Config, max_batches: int = 0, start: int = 0,
                      drop_cameras: Sequence[str] = ()) -> Dict[str, float]:
    """Average eval metrics over (up to) one epoch; ``start`` rotates
    partial passes across the split (HostPipeline.epoch). ``drop_cameras``
    are removed from every batch: scored as dead sensors. A pipeline of
    a rank's slices gives each global batch's metrics, averaged over the
    ranks."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in pipeline.epoch(max_batches=max_batches, start=start):
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
    """Raise, as the reference's fit does, for a global batch that
    ``n_dev`` devices do not divide and for ``bn_stats="pallas"`` on more
    than one (ValueError), and NotImplementedError, naming its ROADMAP.md
    item, for each option of the JAX package's fit that the port lacks."""
    t, m, d = cfg.train, cfg.model, cfg.data
    dist.check_supported(cfg)
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
    later = {
        "train.init_from": (bool(t.init_from), 9),
        "train.init_from_torch": (bool(t.init_from_torch), 9),
        "train.early_stop_patience > 0": (t.early_stop_patience > 0, 9),
        "train.profile_dir": (bool(t.profile_dir), 9),
        "train.debug_nans": (t.debug_nans, 9),
        "train.ema_decay > 0": (t.ema_decay > 0, 9),
        "train.ema_bn_recal_batches > 0": (t.ema_bn_recal_batches > 0, 9),
        "train.grad_accum > 1": (t.grad_accum > 1, 9),
        "train.flat_optimizer": (t.flat_optimizer, 9),
        "model.freeze_backbone": (m.freeze_backbone, 9),
        "data.device_cache": (d.device_cache, 9),
        "data.augment_device": (d.augment_device, 9),
    }
    for name, (used, item) in later.items():
        if used:
            raise NotImplementedError(
                f"{name}: not in the port yet (ROADMAP.md queue A, item "
                f"{item})")


def fit(cfg: Config, device: torch.device) -> Dict[str, Any]:
    """Train per cfg on ``device`` from freshly initialized weights (seed
    train.seed), or from the checkpoint in train.ckpt_dir that
    train.resume names; returns train_on's result.

    When dist.num_devices resolves to N > 1 and this process is not a rank
    yet, N ranks are launched, on cuda:0 .. N-1 over "nccl" (on the CPU N
    times over "gloo"), and the result holds rank 0's metrics, and the
    state and model of its final checkpoint on ``device``."""
    device = torch.device(device)
    n = dist.resolve_num_devices(cfg, device)
    check_fit_supported(cfg, n)
    if n > 1 and not dist.is_initialized():
        out = dist.launch(fit_rank, cfg, dist.rank_devices(device, n),
                          dist.default_backend(device))[0]
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


def restore_final(cfg: Config, device: torch.device,
                  metrics: Dict[str, float], ckpt_path: Optional[str]
                  ) -> Dict[str, Any]:
    """What fit returns, for launched ranks that returned ``metrics`` and
    the final checkpoint ``ckpt_path``: the state and model of that
    checkpoint, restored on ``device`` (a fresh state when None)."""
    state = create_state(cfg, device)
    if ckpt_path is not None:
        _, state_dict, training = checkpoint.load_training(ckpt_path)
        state.model.load_state_dict(state_dict, strict=True)
        state.optimizer.load_state_dict(training["optimizer"])
        state.step = int(training["step"])
    return {"state": state, "model": state.model, "metrics": metrics,
            "ckpt_dir": cfg.train.ckpt_dir, "ckpt_path": ckpt_path}


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
    ``__len__``, ``get_batch`` and ``proprio_stats``) for train.steps,
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
        # a resumed run's checkpoint overwrites them below, so it keeps
        # the statistics its weights were trained with
        mean, std = dataset.proprio_stats()
        with torch.no_grad():
            model.proprio.proprio_mean.copy_(torch.from_numpy(mean))
            model.proprio.proprio_std.copy_(torch.from_numpy(std))

    start_step = 0
    best_val = float("inf")
    ckpt_path: Optional[str] = None
    if resume is not None:
        ckpt_path, _ = checkpoint.resolve(tcfg.ckpt_dir, resume)
        _, state_dict, training = checkpoint.load_training(ckpt_path)
        model.load_state_dict(state_dict, strict=True)
        state.optimizer.load_state_dict(training["optimizer"])
        state.step = start_step = int(training["step"])
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
    train_pipe = HostPipeline(dataset, cfg.data, device=device, train=True,
                              rank=rank, world=world)
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
                             batch_size=eval_bs, rank=rank, world=world)
    schedule = state.optimizer.schedule
    metrics_path = tcfg.metrics_path or f"{tcfg.ckpt_dir}/metrics.jsonl"
    # rank 0 writes the metrics, as it writes the checkpoints
    logger = MetricsLogger(metrics_path if rank == 0 else "",
                           tensorboard=tcfg.tensorboard and rank == 0,
                           tb_dir=tcfg.ckpt_dir)

    def training_state(**extra) -> Dict[str, Any]:
        return {"step": state.step, "optimizer": state.optimizer.state_dict(),
                "pipeline": train_pipe.state_dict(), **extra}

    def save(step: int) -> str:
        # a step saved by an earlier run (an explicit-step resume re-walks
        # them) is replaced; rank 0 writes, and no rank goes on before
        path = checkpoint.save_step(tcfg.ckpt_dir, step, tcfg.ckpt_keep, cfg,
                                    model.state_dict(), training_state())
        dist.barrier()
        return path

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
    log_anchor = start_step
    t_log = time.perf_counter()
    try:
        for step_i in range(start_step, tcfg.steps, spc):
            for _ in range(spc):
                m = train_step(state, next(train_pipe), tcfg)
            step1 = step_i + spc
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
                    "lr": float(schedule(step1)),
                })
                logger.log(step1, last_metrics, prefix="train/")
            if tcfg.eval_every and (step1 % tcfg.eval_every == 0
                                    or step1 == tcfg.steps):
                eval_start = (step1 // tcfg.eval_every) * max(tcfg.eval_steps,
                                                              0)
                em = evaluate_pipeline(model, eval_pipe, cfg,
                                       max_batches=tcfg.eval_steps,
                                       start=eval_start)
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
                        checkpoint.save_best(
                            tcfg.ckpt_dir, step1, cfg, model.state_dict(),
                            training_state(best_val=float(v)))
                        dist.barrier()
                # eval time is not train throughput
                t_log = time.perf_counter()
                log_anchor = step1
            if tcfg.ckpt_every and step1 % tcfg.ckpt_every == 0:
                ckpt_path = save(step1)
                last_saved = step1
            # every rank stops at the same step when any received it
            if dist.any_rank(preempt_signum is not None):
                final_step = step1
                last_metrics["preempted_at"] = float(step1)
                logger.log(step1, {"preempted_at": float(step1)},
                           prefix="train/")
                break
        # nothing to save when a finished run is run again
        if start_step < final_step and last_saved != final_step:
            ckpt_path = save(final_step)
        logger.close()
        train_pipe.close()
        eval_pipe.close()
    finally:
        if sig_installed:
            signal.signal(signal.SIGTERM, prev_sigterm)
    return {"state": state, "model": model, "metrics": last_metrics,
            "ckpt_dir": tcfg.ckpt_dir, "ckpt_path": ckpt_path}
