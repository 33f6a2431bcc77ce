"""Quaternion math of the serving and training paths (counterpart of the
JAX package's ``ops/pose_math.py``): normalization and the distances the
losses and metrics use. The rest of that module (rot6d, products,
mirroring) comes in a later slice.

Every distance depends only on <q, q'>, so it is invariant to the storage
convention and to the antipodal sign q ~ -q.
"""

from __future__ import annotations

import torch

# Keep a margin from |dot| == 1 so arccos' gradient (which blows up like
# 1/sqrt(1-x^2)) stays finite.
_ACOS_CLIP = 1.0 - 1e-6


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


def quat_abs_dot(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """|<q1, q2>|, antipodal-invariant alignment in [0, 1]. Its gradient
    at <q1, q2> = 0 is the JAX package's (that of the + branch), where
    torch.abs would give 0."""
    d = torch.sum(q1 * q2, dim=-1)
    return torch.where(d >= 0, d, -d)


def quat_geodesic_angle(q1: torch.Tensor, q2: torch.Tensor,
                        grad_safe: bool = True) -> torch.Tensor:
    """Geodesic rotation angle in radians, 2 arccos(|<q1,q2>|) in [0, pi],
    of unit quaternions. With grad_safe (for losses) the dot is clipped
    away from 1 so arccos' gradient stays finite, which floors the angle
    at about 2.8e-3 rad; metrics pass grad_safe=False. The clip is
    maximum then minimum, as jnp.clip, so that a value on a bound gets
    half the gradient there, as in the JAX package (torch.clamp passes
    all of it)."""
    hi = _ACOS_CLIP if grad_safe else 1.0
    d = quat_abs_dot(q1, q2)
    d = torch.minimum(torch.maximum(d, d.new_tensor(0.0)), d.new_tensor(hi))
    return 2.0 * torch.arccos(d)


def quat_chordal_distance(q1: torch.Tensor, q2: torch.Tensor
                          ) -> torch.Tensor:
    """Smooth antipodal-safe surrogate 1 - <q1,q2>^2 in [0, 1]."""
    d = torch.sum(q1 * q2, dim=-1)
    return 1.0 - torch.square(d)
