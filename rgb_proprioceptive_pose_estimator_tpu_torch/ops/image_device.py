"""On-device image normalization, the first op of every image encoder
(counterpart of the JAX package's ``ops/image_device.py``).

uint8 images go to the ``normalize_u8`` kernel on CUDA (its plain version
on the CPU). Float images, already scaled to [0, 1], stay plain torch. The
kernel takes every shape whose channel dim is a multiple of the stats
length, so there is no fallback for shapes it cannot tile.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops.fused import normalize_u8


def normalize_images(images: torch.Tensor, mean: Sequence[float],
                     std: Sequence[float],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 or float images (..., H, W, C) -> normalized ``dtype`` images.

    ``mean``/``std`` are per-channel in [0, 1] units. A channel dim of 3T
    (T frames stacked along channels) repeats the stats T times."""
    c = images.shape[-1]
    if len(mean) != len(std):
        raise ValueError(
            f"mean ({len(mean)}) and std ({len(std)}) lengths differ")
    nch = len(mean)
    if c % nch != 0:
        raise ValueError(f"channel dim {c} not a multiple of stats len {nch}")
    if images.dtype == torch.uint8:
        # the kernel repeats the stats along C itself
        return normalize_u8(images, mean, std, dtype)
    reps = c // nch
    m = torch.tensor(tuple(mean) * reps, dtype=torch.float32,
                     device=images.device)
    s = torch.tensor(tuple(std) * reps, dtype=torch.float32,
                     device=images.device)
    return ((images.float() - m) / s).to(dtype)
