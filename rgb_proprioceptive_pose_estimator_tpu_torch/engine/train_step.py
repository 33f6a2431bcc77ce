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

The model's randomness in training (camera dropout) comes from a
``torch.Generator`` made anew for each step from ``(train.seed, step)``,
as the JAX package folds the step into its dropout key: a resumed run
draws the same masks as a straight one.

On a rank of a data-parallel group the step runs the state's
DistributedDataParallel wrapper: each rank's loss is the mean over its
equal share of the global batch, and DDP averages the gradients, so the
clip, the global norm and the update see the global batch's gradients;
the loss components it returns are averaged over the ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import TrainConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
    pose_loss,
    pose_metrics,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

ADAM_EPS = 1e-8                  # optax's adam/adamw default
SGD_MOMENTUM = 0.9


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count (0 for the
    first update), as the JAX package's optax schedules give it:
    constant (a linear warmup from 0 if warmup_steps > 0),
    ``optax.warmup_cosine_decay_schedule`` from 0, or multistep with
    torch MultiStepLR's inclusive milestones (times the warmup ramp)."""
    if cfg.grad_accum > 1:
        raise NotImplementedError("train.grad_accum > 1: not in the port "
                                  "yet (ROADMAP.md queue A, item 9)")
    warmup = cfg.warmup_steps if cfg.warmup_steps > 0 else 0
    total = max(cfg.steps, 1)
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
        bounds = list(cfg.lr_decay_steps)

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


class Optimizer:
    """The JAX package's optax chain over a model's parameters: an
    optional ``clip_by_global_norm(grad_clip)``, then ``adam``, ``adamw``
    (decaying every parameter, BatchNorm affines and biases included, as
    optax's default mask does) or ``sgd`` with momentum 0.9, at
    ``schedule(count)`` for update ``count``."""

    def __init__(self, cfg: TrainConfig, params: Iterable[torch.nn.Parameter]):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = make_lr_schedule(cfg)
        self.grad_clip = cfg.grad_clip
        if cfg.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=0.0, eps=ADAM_EPS)
        elif cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.params, lr=0.0, eps=ADAM_EPS,
                                           weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=0.0,
                                         momentum=SGD_MOMENTUM)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.count = 0

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def _clip(self) -> None:
        # optax: where(norm < max, g, g / norm * max), without a host sync
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.grad_clip))

    def step(self) -> None:
        if self.grad_clip > 0:
            self._clip()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        """The inner optimizer's state and the update count, which the
        learning-rate schedule reads: a resumed run goes on at the saved
        point of its warmup and decay."""
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def dropout_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """The model's random stream of train step ``step`` of a run seeded
    ``seed``, on ``device``: the counterpart of the JAX package's
    ``fold_in(fold_in(rng, 1), step)``, a function of (seed, step) only
    (its numbers differ from JAX's)."""
    mixed = np.random.SeedSequence([seed, 1, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _loss(model, batch, cfg: TrainConfig, generator=None):
    pos, quat = model(batch, generator=generator)
    loss, aux = pose_loss(pos, quat, batch["target_pos"],
                          batch["target_quat"], pos_weight=cfg.pos_weight,
                          rot_weight=cfg.rot_weight, rot_loss=cfg.rot_loss,
                          pos_loss=cfg.pos_loss, huber_delta=cfg.huber_delta)
    return pos, quat, loss, aux


def forward_backward(model: torch.nn.Module, batch: Dict,
                     cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Train-mode forward, loss and backward: the gradients land in the
    parameters' ``.grad`` (cleared first), the BatchNorm running statistics
    are updated. ``generator`` draws the model's dropout masks. Returns the
    loss components, detached (averaged over the ranks of a group)."""
    model.train()
    for p in model.parameters():
        p.grad = None
    _, _, loss, aux = _loss(model, batch, cfg, generator)
    loss.backward()
    return dist.mean({k: v.detach() for k, v in aux.items()})


def train_step(state, batch: Dict, cfg: TrainConfig
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step of ``state`` (engine/state.TrainState) on
    ``batch``; returns the step's metrics as device tensors."""
    model = state.model
    generator = None
    if model.cfg.camera_dropout > 0:
        generator = dropout_generator(cfg.seed, state.step,
                                      next(model.parameters()).device)
    runner = model if state.ddp is None else state.ddp
    metrics = forward_backward(runner, batch, cfg, generator)
    if cfg.log_grad_norm:
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.optimizer.params if p.grad is not None)
    state.optimizer.step()
    state.step += 1
    return metrics


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
