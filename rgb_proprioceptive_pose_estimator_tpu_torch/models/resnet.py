"""ResNet-18/34/50 image encoders (counterpart of the JAX package's
``models/resnet.py``): torchvision's topologies with the classifier
replaced by a feature projection.

The stem is the plain 7x7/2 conv with pad 3 on the same ``(7,7,3,64)``
parameter the JAX package keeps for its space-to-depth stem
(``model.stem_s2d``), which is a TPU matrix-unit device with no port; the
two compute the same function.

``remat`` recomputes each residual block's activations in the backward
(``torch.utils.checkpoint``, train mode only), as ``model.remat`` has the
JAX package do with ``nn.remat``; the recomputation leaves the BatchNorm
running statistics alone, so a step updates them once and its numbers
equal those without remat.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    ConvBNReLU,
    Dense,
    running_stats_frozen,
)


class BasicBlock(nn.Module):
    """3x3 -> 3x3, with a 1x1-conv shortcut where the shape changes."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_stats: str = "reduce"):
        super().__init__()
        # symmetric pad 1, torch's convention (JAX pads explicitly to match)
        self.conv1 = ConvBNReLU(in_features, features, (3, 3),
                                (stride, stride), (1, 1),
                                compute_dtype=compute_dtype,
                                bn_stats=bn_stats)
        self.conv2 = ConvBNReLU(features, features, (3, 3), (1, 1), (1, 1),
                                act=False, compute_dtype=compute_dtype,
                                bn_stats=bn_stats)
        self.downsample = _shortcut(in_features, features, stride,
                                    compute_dtype, bn_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 to 4x the width, with a 1x1-conv
    shortcut where the shape changes: at every stage's first block,
    including stage 1's (stride 1, 64 -> 256)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_stats: str = "reduce"):
        super().__init__()
        out = features * self.expansion
        kw = dict(compute_dtype=compute_dtype, bn_stats=bn_stats)
        self.conv1 = ConvBNReLU(in_features, features, (1, 1), (1, 1),
                                (0, 0), **kw)
        self.conv2 = ConvBNReLU(features, features, (3, 3), (stride, stride),
                                (1, 1), **kw)
        self.conv3 = ConvBNReLU(features, out, (1, 1), (1, 1), (0, 0),
                                act=False, **kw)
        self.downsample = _shortcut(in_features, out, stride, compute_dtype,
                                    bn_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


def _shortcut(in_features: int, out: int, stride: int,
              compute_dtype: torch.dtype, bn_stats: str):
    """The 1x1 conv + BN shortcut where the JAX package's ``residual.shape
    != y.shape`` (a stride or a change of width), else None."""
    if stride == 1 and in_features == out:
        return None
    return ConvBNReLU(in_features, out, (1, 1), (stride, stride), (0, 0),
                      act=False, compute_dtype=compute_dtype,
                      bn_stats=bn_stats)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNet(nn.Module):
    """NHWC images in the compute dtype -> (B, features) embedding."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: str = "basic", features: int = 512,
                 in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_stats: str = "reduce", remat: bool = False):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"block must be one of {sorted(BLOCKS)}, got "
                             f"{block!r}")
        block_cls = BLOCKS[block]
        self.remat = remat
        self.stem = ConvBNReLU(in_channels, 64, (7, 7), (2, 2), (3, 3),
                               compute_dtype=compute_dtype, bn_stats=bn_stats)
        width_in = 64
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            width = 64 * (2 ** stage)
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_block{i}"
                self.add_module(name, block_cls(
                    width_in, width, stride, compute_dtype=compute_dtype,
                    bn_stats=bn_stats))
                self.block_names.append(name)
                width_in = width * block_cls.expansion
        self.proj = Dense(width_in, features, compute_dtype=compute_dtype)
        # channels innermost everywhere: convolutions given channels_last
        # input and weights return channels_last
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last view
        x = self.stem(x)
        x = torch.nn.functional.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            block = getattr(self, name)
            if self.remat and self.training:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=functools.partial(
                                   _remat_contexts, block))
            else:
                x = block(x)
        x = x.mean(dim=(2, 3))             # global average pool
        return torch.relu(self.proj(x))


def _remat_contexts(block: nn.Module):
    """(forward, recomputation) contexts of a checkpointed block: the
    recomputation does not update the running statistics again."""
    return contextlib.nullcontext(), running_stats_frozen(block)


def ResNet18(features: int = 512, in_channels: int = 3,
             compute_dtype: torch.dtype = torch.float32,
             bn_stats: str = "reduce", remat: bool = False) -> ResNet:
    return ResNet((2, 2, 2, 2), "basic", features=features,
                  in_channels=in_channels, compute_dtype=compute_dtype,
                  bn_stats=bn_stats, remat=remat)


def ResNet34(features: int = 512, in_channels: int = 3,
             compute_dtype: torch.dtype = torch.float32,
             bn_stats: str = "reduce", remat: bool = False) -> ResNet:
    """torchvision resnet34's topology: BasicBlock x (3, 4, 6, 3)."""
    return ResNet((3, 4, 6, 3), "basic", features=features,
                  in_channels=in_channels, compute_dtype=compute_dtype,
                  bn_stats=bn_stats, remat=remat)


def ResNet50(features: int = 1024, in_channels: int = 3,
             compute_dtype: torch.dtype = torch.float32,
             bn_stats: str = "reduce", remat: bool = False) -> ResNet:
    """torchvision resnet50's topology: Bottleneck x (3, 4, 6, 3)."""
    return ResNet((3, 4, 6, 3), "bottleneck", features=features,
                  in_channels=in_channels, compute_dtype=compute_dtype,
                  bn_stats=bn_stats, remat=remat)
