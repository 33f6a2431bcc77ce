"""Small 4-layer CNN image encoder for 64x64 renders (counterpart of the
JAX package's ``models/cnn_small.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    ConvBNReLU,
    Dense,
)


class CNNSmall(nn.Module):
    """Four stride-2 3x3 ConvBNReLU blocks with flax ``"SAME"`` padding,
    global average pool, projection, ReLU: NHWC images in the compute
    dtype -> (B, features). 64x64 input is 4x4 at the last block. Module
    names follow the JAX tree (``block<i>``, ``proj``)."""

    def __init__(self, features: int = 256,
                 channels: Sequence[int] = (32, 64, 128, 256),
                 in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_stats: str = "reduce"):
        super().__init__()
        self.n_blocks = len(channels)
        width_in = in_channels
        for i, ch in enumerate(channels):
            self.add_module(f"block{i}", ConvBNReLU(
                width_in, ch, (3, 3), (2, 2), "SAME",
                compute_dtype=compute_dtype, bn_stats=bn_stats))
            width_in = ch
        self.proj = Dense(width_in, features, compute_dtype=compute_dtype)
        # channels innermost everywhere, as in models/resnet.py
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last view
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = x.mean(dim=(2, 3))             # global average pool
        return torch.relu(self.proj(x))
