"""Training state (counterpart of the JAX package's ``engine/state.py``):
the model, its optimizer, the step count, a ``torch.Generator``, the EMA
of the parameters (``train.ema_decay``), and the model's data-parallel
wrapper on a rank of a group.

The JAX package threads one immutable pytree through a compiled step; here
the model and optimizer are updated in place by each step.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    Optimizer,
    make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    BatchNormAct,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import PoseEstimator
from rgb_proprioceptive_pose_estimator_tpu_torch.models.lstm import (
    LSTM,
    RECURRENT_KERNELS,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.vit import (
    HeadDense,
    LayerNorm,
    ViT,
)

# flax's lecun_normal draws from a normal truncated at 2 std and rescales
# by this constant so that the variance stays 1/fan_in
_TRUNC_STD = 0.87962566103423978


@dataclass
class TrainState:
    model: PoseEstimator
    optimizer: Optimizer
    step: int
    generator: torch.Generator     # host-side randomness of the run
    # the model in DistributedDataParallel on a rank of a group of more
    # than one (parallel/dist.data_parallel): the train step runs it
    ddp: Optional[nn.Module] = None
    # EMA of the parameters, by name (train.ema_decay > 0), else None
    ema: Optional[Dict[str, torch.Tensor]] = None

    def serving_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights every evaluation consumer serves (the reference's
        ``eval_variables``): the EMA's parameters when it is on, else the
        raw ones, with the model's buffers."""
        return {**self.model.state_dict(), **(self.ema or {})}


def ema_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """An EMA that starts at ``model``'s parameters (copies)."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@contextlib.contextmanager
def serving(model: nn.Module, ema: Optional[Dict[str, torch.Tensor]],
            stats: Optional[Dict[str, torch.Tensor]] = None
            ) -> Iterator[nn.Module]:
    """Inside, ``model`` holds the EMA's parameters (when ``ema`` is not
    None) and the BatchNorm running statistics ``stats`` (when given);
    its own come back at the exit."""
    swap = dict(ema or {})
    swap.update(stats or {})
    if not swap:
        yield model
        return
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    saved = {k: tensors[k].detach().clone() for k in swap}
    with torch.no_grad():
        for k, v in swap.items():
            tensors[k].copy_(v)
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                tensors[k].copy_(v)


def _lecun_normal(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``:
    He-normal (fan out) convolutions, LeCun truncated-normal dense kernels
    (the LSTM's input kernels, the ViT's patch embedding and attention
    kernels too), orthogonal LSTM recurrent kernels, zero biases,
    BatchNorm and LayerNorm scale 1 and shift 0, identity running and
    proprio statistics, and the ViT's position embedding normal with std
    0.02 and class token 0. (The draws differ from JAX's: tests hand both
    packages the same weights instead.)"""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal(mod.weight, mod.in_features, generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, HeadDense):
                w = mod.weight
                _lecun_normal(w, w.shape[0] * (w.shape[1] if mod.out else 1),
                              generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, (BatchNormAct, LayerNorm)):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            if isinstance(mod, BatchNormAct):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        # after the pass above, which visits the LSTM's dense layers and
        # the ViT's patch convolution too
        for mod in model.modules():
            if isinstance(mod, LSTM):
                for name in RECURRENT_KERNELS:
                    nn.init.orthogonal_(getattr(mod, name).weight,
                                        generator=generator)
            elif isinstance(mod, ViT):
                w = mod.patch_embed.weight
                _lecun_normal(w, w[0].numel(), generator)
                nn.init.zeros_(mod.patch_embed.bias)
                nn.init.normal_(mod.pos_embed, std=0.02, generator=generator)
                if mod.pool == "cls":
                    nn.init.zeros_(mod.cls_token)


def create_state(cfg: Config, device: torch.device,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None
                 ) -> TrainState:
    """A fresh state on ``device``: weights from ``state_dict`` (strict) or
    from the initializers with seed ``train.seed``, an optimizer at update
    0 (``make_optimizer``: model.freeze_backbone takes the frozen
    parameters out), and with train.ema_decay an EMA at the initial
    parameters."""
    seed = cfg.train.seed
    model = PoseEstimator(cfg.model)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model),
                      step=0,
                      generator=torch.Generator().manual_seed(seed ^ 0xA46),
                      ema=ema_of(model) if cfg.train.ema_decay > 0 else None)
