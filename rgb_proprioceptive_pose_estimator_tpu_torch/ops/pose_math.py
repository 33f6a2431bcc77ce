"""Quaternion math of the serving path (counterpart of the JAX package's
``ops/pose_math.py``). The rest of that module (rot6d, distances) comes
with the losses of the training slice."""

from __future__ import annotations

import torch


def _soft_normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    """v / sqrt(|v|^2 + eps^2): unit-normalize with a finite value and
    gradient at v == 0 (the raw pose head emits exactly 0 when every input
    feature of a sample is zeroed). For any |v| well above eps this equals
    the exact norm to f32 precision."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(sq + eps * eps)


def quat_normalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize to a unit quaternion (soft norm, see _soft_normalize)."""
    return _soft_normalize(q, eps)
