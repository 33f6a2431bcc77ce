"""The train and eval steps (counterpart of the JAX package's
``engine/train_step.py``).

One train step: train-mode forward (BatchNorm normalizes by the batch and
updates its running statistics), the f32 pose loss, backward, and the
update of the JAX package's optax chain: an optional global-norm clip, then
adam, adamw or sgd at the schedule's learning rate for the update count.
PyTorch runs eagerly, so there is no compiled program; the optimizer's
arithmetic is ``torch.optim``'s, which equals optax's algebraically and
rounds differently (AdamW decays before it steps, optax adds the decay to
the update), so the two agree by trajectory, not bit for bit.

The rest of the reference's chain:

- ``train.grad_accum`` = k (``optax.MultiSteps``): each call is a
  micro-step on a micro-batch of ``data.batch_size``; the gradients sum
  in the parameters' ``.grad`` over k calls, and the k-th applies one
  update from their mean. The schedules count updates. Under data
  parallelism micro-steps 1..k-1 run in DDP's ``no_sync``, so the
  gradients are all-reduced once per update.
- ``model.freeze_backbone``: the ``encoder_*`` and ``lstm_*`` parameters
  are not in the optimizer (optax's ``multi_transform`` with
  ``set_to_zero``): the clip's norm covers the trainable ones only and
  the frozen ones get no decay. They take no gradient, so the encoders'
  backward does not run, unless ``train.log_grad_norm`` asks for the
  norm of every gradient, frozen ones included, as the reference logs
  it. Their BatchNorm running statistics still update.
- ``train.ema_decay`` = d: after every update the EMA becomes
  ``d * ema + (1 - d) * params``; it holds between micro-steps.
- ``train.debug_nans``: a NaN in the loss or a gradient raises
  FloatingPointError before the update.

The model's randomness in training (camera dropout) comes from a
``torch.Generator`` made anew for each step from ``(train.seed, step)``,
as the JAX package folds the step into its dropout key: a resumed run
draws the same masks as a straight one.

The device-resident data path (``data.device_cache``,
``data.augment_device``): a batch that carries ``image_idx`` instead of
images gets its frames by an ``index_select`` of the uint8 cache on the
device (``gather_cached_images``; under the sharded layout the indices
are rows of the rank's own shard, so the gather is local with no
collective), then, with ``data.augment_device``, crop, flip and jitter on
the device (ops/image_augment_device.py), drawn from a stream of its own
per step, apart from dropout's, as the reference keeps ``fold_in(rng,
step)`` apart from ``fold_in(fold_in(rng, 1), step)``.

On a rank of a data-parallel group the step runs the state's
DistributedDataParallel wrapper: each rank's loss is the mean over its
equal share of the global batch, and DDP averages the gradients, so the
clip, the global norm and the update see the global batch's gradients;
the loss components it returns are averaged over the ranks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    Config,
    ModelConfig,
    TrainConfig,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
    pose_loss,
    pose_metrics,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops import (
    image_augment_device as ida,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

ADAM_EPS = 1e-8                  # optax's adam/adamw default
SGD_MOMENTUM = 0.9


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count (0 for the
    first update), as the JAX package's optax schedules give it:
    constant (a linear warmup from 0 if warmup_steps > 0),
    ``optax.warmup_cosine_decay_schedule`` from 0, or multistep with
    torch MultiStepLR's inclusive milestones (times the warmup ramp).
    With train.grad_accum = k the horizons, given in micro-steps as
    ``steps`` is, are divided by k (warmup and milestones rounded up)."""
    accum = max(cfg.grad_accum, 1)
    warmup = -(-cfg.warmup_steps // accum) if cfg.warmup_steps > 0 else 0
    total = max(cfg.steps // accum, 1)
    lr = cfg.lr

    def linear(count: int, steps: int) -> float:
        # optax.linear_schedule(0, lr, steps)
        c = min(max(count, 0), steps)
        return (0.0 - lr) * (1.0 - c / steps) + lr

    if cfg.lr_schedule == "cosine":
        w = max(warmup, 1)
        decay = max(total, warmup + 1) - w

        def cosine(count: int) -> float:
            if count < w:
                return linear(count, w)
            c = min(count - w, decay)
            return lr * (0.5 * (1.0 + math.cos(math.pi * c / decay)))

        return cosine
    if cfg.lr_schedule == "multistep":
        bounds = [-(-m // accum) for m in cfg.lr_decay_steps]

        def multistep(count: int) -> float:
            v = lr * cfg.lr_decay_rate ** sum(count >= b for b in bounds)
            if warmup > 0:
                v *= min(count / warmup, 1.0)
            return v

        return multistep
    if warmup > 0:
        return lambda count: linear(count, warmup)
    return lambda count: lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


FROZEN_PREFIXES = ("encoder_", "lstm_")


def frozen_prefixes_for(cfg: Config) -> Tuple[str, ...]:
    """Parameter-name prefixes model.freeze_backbone takes out of
    training: the camera encoders and their LSTMs."""
    return FROZEN_PREFIXES if cfg.model.freeze_backbone else ()


class Optimizer:
    """The JAX package's optax chain over a model's trainable parameters:
    an optional ``clip_by_global_norm(grad_clip)``, then ``adam``,
    ``adamw`` (decaying every parameter it updates, BatchNorm affines and
    biases included, as optax's default mask does) or ``sgd`` with
    momentum 0.9, at ``schedule(count)`` for update ``count``, applied
    every ``train.grad_accum`` calls of ``step`` to the mean of the
    gradients summed in ``.grad`` meanwhile (``optax.MultiSteps``).

    ``train.flat_optimizer`` (``optax.flatten``) runs the update through
    torch's multi-tensor ``foreach`` kernels, a few launches over all the
    parameters at once; the arithmetic is the per-parameter one."""

    def __init__(self, cfg: TrainConfig, params: Iterable[torch.nn.Parameter]):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = make_lr_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        self.accum = max(cfg.grad_accum, 1)
        self.foreach = True if cfg.flat_optimizer else None
        kw = {"lr": 0.0, "foreach": self.foreach}
        if cfg.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, eps=ADAM_EPS, **kw)
        elif cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.params, eps=ADAM_EPS,
                                           weight_decay=cfg.weight_decay,
                                           **kw)
        elif cfg.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, momentum=SGD_MOMENTUM,
                                         **kw)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.count = 0          # updates applied
        self.mini_step = 0      # micro-steps summed in .grad since the last

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @property
    def applies(self) -> bool:
        """Whether the next call of ``step`` applies an update."""
        return self.mini_step == self.accum - 1

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def _clip(self) -> None:
        # optax: where(norm < max, g, g / norm * max), without a host sync
        grads = self._grads()
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.grad_clip))

    def step(self) -> bool:
        """One micro-step: returns True when it applied an update."""
        if not self.applies:
            self.mini_step += 1
            return False
        if self.accum > 1:
            grads = self._grads()
            if self.foreach:
                torch._foreach_div_(grads, float(self.accum))
            else:
                for g in grads:
                    g.div_(self.accum)
        if self.grad_clip > 0:
            self._clip()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        self.mini_step = 0
        return True

    def average_accumulator(self) -> None:
        """On a rank of a group, between the micro-steps of an update:
        replace each rank's gradient sum (rank-local under ``no_sync``) by
        the ranks' mean, so that one checkpoint holds it; the update that
        follows is unchanged, as DDP's all-reduce then averages the same
        sums. Collective: every rank calls it."""
        if self.mini_step and dist.world() > 1:
            for g in self._grads():
                dist.sum_(g)
                g.div_(dist.world())

    def state_dict(self) -> Dict:
        out = {"inner": self.inner.state_dict(), "count": self.count,
               "mini_step": self.mini_step}
        if self.mini_step:
            # MultiSteps' accumulator: the gradient sums so far
            out["accumulated"] = [None if p.grad is None
                                  else p.grad.detach().clone()
                                  for p in self.params]
        return out

    def load_state_dict(self, state: Dict) -> None:
        """The inner optimizer's state, the update count, which the
        learning-rate schedule reads (a resumed run goes on at the saved
        point of its warmup and decay), and, mid-accumulation, the
        micro-step count and the gradient sums."""
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        if self.mini_step >= self.accum:
            raise ValueError(
                f"the checkpoint is at micro-step {self.mini_step} of an "
                f"update, and train.grad_accum is {self.accum}")
        saved = state.get("accumulated") or [None] * len(self.params)
        for p, g in zip(self.params, saved):
            p.grad = None if g is None else g.to(p.device).clone()


def make_optimizer(cfg: Config, model: torch.nn.Module) -> Optimizer:
    """The optimizer of ``model``'s trainable parameters: all of them, or
    under model.freeze_backbone those outside ``frozen_prefixes_for``,
    whose ``requires_grad`` goes off here so that no gradient reaches
    them (the frozen encoders' backward does not run), except with
    train.log_grad_norm, whose norm covers them."""
    frozen = frozen_prefixes_for(cfg)
    if frozen and cfg.train.flat_optimizer:
        raise ValueError(
            "model.freeze_backbone is incompatible with "
            "train.flat_optimizer (optax.flatten erases the tree "
            "structure the freeze mask needs)")
    params = []
    for name, p in model.named_parameters():
        if frozen and name.startswith(frozen):
            p.requires_grad_(cfg.train.log_grad_norm)
        else:
            params.append(p)
    return Optimizer(cfg.train, params)


def _generator(seed: int, stream: int, count: int,
               device: torch.device) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, stream, count]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def aug_generator(seed: int, step: int,
                  device: torch.device) -> torch.Generator:
    """The device augmentation's random stream of train step ``step``
    (the reference's ``fold_in(rng, step)``)."""
    return _generator(seed, 0, step, device)


def recal_aug_generator(seed: int, batch: int,
                        device: torch.device) -> torch.Generator:
    """The device augmentation's random stream of BN recalibration
    forward ``batch`` (the reference's ``fold_in(fold_in(rng, 2),
    salt)``)."""
    return _generator(seed, 2, batch, device)


def dropout_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """The model's random stream of train step ``step`` of a run seeded
    ``seed``, on ``device``: the counterpart of the JAX package's
    ``fold_in(fold_in(rng, 1), step)``, a function of (seed, step) only
    (its numbers differ from JAX's)."""
    return _generator(seed, 1, step, device)


def recal_generator(seed: int, batch: int,
                    device: torch.device) -> torch.Generator:
    """The model's random stream of BN recalibration forward ``batch``
    (the reference's ``fold_in(fold_in(rng, 3), salt)``)."""
    return _generator(seed, 3, batch, device)


def device_aug_of(cfg: Config) -> Optional[Dict]:
    """The device augmentation's arguments (``augment_batch_images``'s
    keywords) when data.augment_device and data.augment are on for an
    image model, else None."""
    d, m = cfg.data, cfg.model
    if not (d.augment_device and d.augment and m.backbone != "none"):
        return None
    return {"cameras": tuple(m.cameras), "out_hw": m.image_size,
            "hflip_prob": d.hflip_prob,
            "hflip_pose_mirror": d.hflip_pose_mirror,
            "hflip_mirror_axis": d.hflip_mirror_axis,
            "hflip_mirror_center": d.hflip_mirror_center,
            "jitter_brightness": d.jitter_brightness,
            "jitter_contrast": d.jitter_contrast,
            "jitter_saturation": d.jitter_saturation,
            "jitter_hue": d.jitter_hue, "jitter_prob": d.jitter_prob,
            "crop_scale": tuple(d.crop_scale),
            "crop_ratio": tuple(d.crop_ratio)}


def gather_cached_images(image_cache: Dict[str, torch.Tensor],
                         batch: Dict) -> Dict:
    """data.device_cache: the batch's frames, gathered from the
    device-resident uint8 cache by its int32 ``image_idx`` ((n,) or (n,
    T)), which leaves the batch. Only the cached cameras are gathered
    (evaluate leaves its dropped cameras out of the cache)."""
    idx = batch["image_idx"]
    out = {k: v for k, v in batch.items() if k != "image_idx"}
    flat = idx.reshape(-1)
    out["images"] = {
        cam: arr.index_select(0, flat).reshape(tuple(idx.shape)
                                               + tuple(arr.shape[1:]))
        for cam, arr in image_cache.items()}
    return out


def augment_on_device(batch: Dict, device_aug: Dict,
                      generator: torch.Generator) -> Dict:
    """``device_aug``'s augmentation of ``batch`` with draws from
    ``generator``; on a rank of a group, the global batch's draws and
    the rank's rows of them."""
    b = batch["images"][device_aug["cameras"][0]].shape[0]
    draws = ida.draw_batch_aug(generator, batch, first=dist.rank() * b,
                               rows=dist.world() * b, **device_aug)
    return ida.augment_batch_images(batch, draws, **device_aug)


def prepare_batch(batch: Dict, image_cache: Optional[Dict] = None,
                  device_aug: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None) -> Dict:
    """The batch the model takes: frames gathered from ``image_cache``
    when the batch carries indices, then augmented on the device with
    ``device_aug`` from ``generator`` when that is set."""
    if image_cache is not None and "image_idx" in batch:
        batch = gather_cached_images(image_cache, batch)
    if device_aug is not None:
        batch = augment_on_device(batch, device_aug, generator)
    return batch


def uses_dropout(cfg: ModelConfig) -> bool:
    """Whether a train-mode forward of the model draws random masks."""
    return cfg.camera_dropout > 0 or cfg.proprio_dropout > 0


def _loss(model, batch, cfg: TrainConfig, generator=None):
    pos, quat = model(batch, generator=generator)
    loss, aux = pose_loss(pos, quat, batch["target_pos"],
                          batch["target_quat"], pos_weight=cfg.pos_weight,
                          rot_weight=cfg.rot_weight, rot_loss=cfg.rot_loss,
                          pos_loss=cfg.pos_loss, huber_delta=cfg.huber_delta)
    return pos, quat, loss, aux


def forward_backward(model: torch.nn.Module, batch: Dict,
                     cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     accumulate: bool = False) -> Dict[str, torch.Tensor]:
    """Train-mode forward, loss and backward: the gradients land in the
    parameters' ``.grad`` (added to what is there with ``accumulate``,
    else cleared first), the BatchNorm running statistics are updated.
    ``generator`` draws the model's dropout masks. Returns the loss
    components, detached (averaged over the ranks of a group)."""
    model.train()
    if not accumulate:
        for p in model.parameters():
            p.grad = None
    _, _, loss, aux = _loss(model, batch, cfg, generator)
    loss.backward()
    return dist.mean({k: v.detach() for k, v in aux.items()})


def _micro_grad_norm(params: List[torch.nn.Parameter],
                     before: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """The global norm of the gradient one micro-step added to ``.grad``,
    the global micro-batch's: the difference averaged over the ranks (a
    rank's sums are its own in ``no_sync``, and the ranks' mean after the
    all-reduce of the last micro-step, which the average undoes)."""
    diffs = [p.grad - (0 if b is None else b) for p, b in zip(params, before)
             if p.grad is not None]
    if dist.world() > 1:
        flat = torch.cat([d.reshape(-1) for d in diffs])
        dist.sum_(flat)
        flat /= dist.world()
        diffs = [flat]
    return global_norm(diffs)


def _check_nans(loss: torch.Tensor, params: List[torch.nn.Parameter],
                step: int) -> None:
    flags = [torch.isnan(loss)] + [torch.isnan(p.grad).any()
                                   for p in params if p.grad is not None]
    if bool(torch.stack(flags).any()):
        raise FloatingPointError(
            f"train.debug_nans: the loss or a gradient of train step "
            f"{step} holds a NaN")


def update_ema(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * params``, per parameter."""
    names = [n for n, _ in model.named_parameters()]
    params = [p.detach() for _, p in model.named_parameters()]
    averages = [ema[n] for n in names]
    torch._foreach_mul_(averages, decay)
    torch._foreach_add_(averages, params, alpha=1.0 - decay)


def train_step(state, batch: Dict, cfg: TrainConfig,
               image_cache: Optional[Dict[str, torch.Tensor]] = None,
               device_aug: Optional[Dict] = None
               ) -> Dict[str, torch.Tensor]:
    """One call of the reference's train step on ``state``
    (engine/state.TrainState): a micro-step of ``train.grad_accum`` (an
    optimizer step when it is 1) on ``batch`` (its frames gathered from
    ``image_cache`` and augmented with ``device_aug`` first, as
    ``prepare_batch`` does); returns the step's metrics as device
    tensors."""
    model, opt = state.model, state.optimizer
    dev = next(model.parameters()).device
    batch = prepare_batch(
        batch, image_cache, device_aug,
        aug_generator(cfg.seed, state.step, dev) if device_aug else None)
    generator = None
    if uses_dropout(model.cfg):
        generator = dropout_generator(cfg.seed, state.step, dev)
    runner = model if state.ddp is None else state.ddp
    sync = (contextlib.nullcontext() if state.ddp is None or opt.applies
            else state.ddp.no_sync())
    # every gradient, the frozen leaves' too (model.freeze_backbone)
    grad_params = [p for p in model.parameters() if p.requires_grad]
    before = None
    if cfg.log_grad_norm and opt.mini_step:
        before = [None if p.grad is None else p.grad.clone()
                  for p in grad_params]
    with sync:
        metrics = forward_backward(runner, batch, cfg, generator,
                                   accumulate=opt.mini_step > 0)
    if cfg.debug_nans:
        _check_nans(metrics["loss"], opt.params, state.step)
    if cfg.log_grad_norm:
        if opt.accum > 1:
            metrics["grad_norm"] = _micro_grad_norm(
                grad_params, before or [None] * len(grad_params))
        else:
            metrics["grad_norm"] = global_norm(
                p.grad for p in grad_params if p.grad is not None)
    if opt.step() and state.ema is not None:
        update_ema(state.ema, model, cfg.ema_decay)
    state.step += 1
    return metrics


@torch.no_grad()
def recalibrate_batch_stats(model: torch.nn.Module, batches: Iterable[Dict],
                            seed: int,
                            image_cache: Optional[Dict] = None,
                            device_aug: Optional[Dict] = None,
                            momentum: float = 0.9
                            ) -> Dict[str, torch.Tensor]:
    """BatchNorm running statistics for ``model``'s weights (torch
    ``swa_utils.update_bn``, the reference's ``recalibrate_batch_stats``):
    a train-mode forward of each batch of ``batches``, each from the
    model's own statistics, whose update gives back the batch's
    statistic as ``(new - m * old) / (1 - m)`` with ``m = momentum``,
    which fit passes as ``model.bn_momentum`` (the reference's rule;
    the layers themselves always update with 0.9, so at another value
    the result is ``(0.9 * old + 0.1 * b - m * old) / (1 - m)``, as in
    the reference); the result is their cumulative average, as
    ``{state_dict key: tensor}``. The model's
    statistics are left as they were. On a rank of a group the forwards'
    statistics are the global batch's. Each batch goes through
    ``prepare_batch`` with ``image_cache`` and ``device_aug``, drawn from
    recalibration's own stream."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
        BatchNormAct,
    )

    layers = {n: m for n, m in model.named_modules()
              if isinstance(m, BatchNormAct)}
    keys = [(f"{n}.{b}", m, b) for n, m in layers.items()
            for b in ("running_mean", "running_var")]
    old = {k: getattr(m, b).clone() for k, m, b in keys}
    dev = next(model.parameters()).device
    cum: Dict[str, torch.Tensor] = {}
    was_training = model.training
    model.train()
    try:
        for i, batch in enumerate(batches):
            batch = prepare_batch(
                batch, image_cache, device_aug,
                recal_aug_generator(seed, i, dev) if device_aug else None)
            generator = (recal_generator(seed, i, dev)
                         if uses_dropout(model.cfg) else None)
            model(batch, generator=generator)
            for k, m, b in keys:
                new = getattr(m, b)
                per_batch = (new - momentum * old[k]) / (1.0 - momentum)
                cum[k] = (per_batch if i == 0
                          else cum[k] + (per_batch - cum[k]) / float(i + 1))
                new.copy_(old[k])
    finally:
        model.train(was_training)
    return cum


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict, cfg: TrainConfig
              ) -> Dict[str, torch.Tensor]:
    """Eval-mode forward (BatchNorm running statistics), the loss
    components and the cm/deg errors."""
    model.eval()
    pos, quat, _, aux = _loss(model, batch, cfg)
    aux.update(pose_metrics(pos, quat, batch["target_pos"],
                            batch["target_quat"]))
    return aux
