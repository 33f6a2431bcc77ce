"""ResNet-18 image encoder (counterpart of the JAX package's
``models/resnet.py``): torchvision's topology with the classifier replaced
by a feature projection.

The stem is the plain 7x7/2 conv with pad 3 on the same ``(7,7,3,64)``
parameter the JAX package keeps for its space-to-depth stem
(``model.stem_s2d``), which is a TPU matrix-unit device with no port; the
two compute the same function.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    ConvBNReLU,
    Dense,
)


class BasicBlock(nn.Module):
    """3x3 -> 3x3, with a 1x1-conv shortcut where the shape changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        # symmetric pad 1, torch's convention (JAX pads explicitly to match)
        self.conv1 = ConvBNReLU(in_features, features, (3, 3),
                                (stride, stride), (1, 1),
                                compute_dtype=compute_dtype)
        self.conv2 = ConvBNReLU(features, features, (3, 3), (1, 1), (1, 1),
                                act=False, compute_dtype=compute_dtype)
        if stride != 1 or in_features != features:
            self.downsample = ConvBNReLU(in_features, features, (1, 1),
                                         (stride, stride), (0, 0), act=False,
                                         compute_dtype=compute_dtype)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """NHWC images in the compute dtype -> (B, features) embedding."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 features: int = 512, in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = ConvBNReLU(in_channels, 64, (7, 7), (2, 2), (3, 3),
                               compute_dtype=compute_dtype)
        width_in = 64
        for stage, n_blocks in enumerate(stage_sizes):
            width = 64 * (2 ** stage)
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                self.add_module(
                    f"stage{stage + 1}_block{i}",
                    BasicBlock(width_in, width, stride,
                               compute_dtype=compute_dtype))
                width_in = width
        self.block_names = [f"stage{s + 1}_block{i}"
                            for s, n in enumerate(stage_sizes)
                            for i in range(n)]
        self.proj = Dense(width_in, features, compute_dtype=compute_dtype)
        # channels innermost everywhere: convolutions given channels_last
        # input and weights return channels_last
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last view
        x = self.stem(x)
        x = torch.nn.functional.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))             # global average pool
        return torch.relu(self.proj(x))


def ResNet18(features: int = 512, in_channels: int = 3,
             compute_dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), features=features, in_channels=in_channels,
                  compute_dtype=compute_dtype)
