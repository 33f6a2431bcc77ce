"""Quaternion math of the serving and training paths (counterpart of the
JAX package's ``ops/pose_math.py``): normalization, the quaternion
algebra (conjugate, Hamilton product, rotation of vectors, axis-angle,
uniform random draws), the distances the losses and metrics use, the
rotation matrix and continuous 6D forms of the rot6d head, and the pose
mirror of device augmentation's label-consistent flip. Quaternions are
(w, x, y, z), and every function broadcasts over leading batch axes as
the reference's does.

Every distance depends only on <q, q'>, so it is invariant to the storage
convention and to the antipodal sign q ~ -q.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

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


def mirror_pose(pos: torch.Tensor, quat: torch.Tensor, axis: int = 0,
                center: float = 0.0):
    """Reflect a pose across the plane {x_axis = center} (normal along
    ``axis``): the label transform matching a horizontal image flip.
    Position: component ``axis`` reflects about ``center``. Orientation:
    R' = M.R.M, whose quaternion (w, x, y, z) keeps w and v_axis and
    negates the other two vector components."""
    pos_sign = torch.ones(3, dtype=pos.dtype, device=pos.device)
    pos_sign[axis] = -1.0
    pos_off = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    pos_off[axis] = 2.0 * center
    quat_sign = -torch.ones(4, dtype=quat.dtype, device=quat.device)
    quat_sign[0] = 1.0
    quat_sign[1 + axis] = 1.0
    return pos * pos_sign + pos_off, quat * quat_sign


def quat_normalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalize to a unit quaternion (soft norm, see _soft_normalize)."""
    return _soft_normalize(q, eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b, broadcasting over batch."""
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors v by unit quaternions q."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)   # linalg.cross wants equal ranks
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor
                         ) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` radians about ``axis``
    (a zero axis gives the identity's (cos, 0, 0, 0))."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(
        1e-8)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Shoemake's map from three uniform [0, 1) draws ``u`` (3, ...) to
    uniformly distributed unit quaternions (..., 4)."""
    u1, u2, u3 = u
    a = torch.sqrt(1.0 - u1)
    b = torch.sqrt(u1)
    return torch.stack([
        a * torch.sin(2 * math.pi * u2),
        a * torch.cos(2 * math.pi * u2),
        b * torch.sin(2 * math.pi * u3),
        b * torch.cos(2 * math.pi * u3),
    ], dim=-1)


def random_quaternion(shape: Sequence[int] = (),
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Uniform random unit quaternions of batch shape ``shape`` (f32),
    drawn from ``generator`` on ``device`` (the generator's when it is
    given) by Shoemake's subgroup algorithm."""
    if device is None and generator is not None:
        device = generator.device
    return quat_from_uniform(torch.rand((3,) + tuple(shape),
                                        generator=generator, device=device))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = torch.unbind(q, dim=-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w,x,y,z).

    The branchless four-candidate form: t_i in {4w^2, 4x^2, 4y^2, 4z^2}
    sum to 4, so the largest is >= 1, and the candidate built from it keeps
    every square root and division well conditioned. The three candidates
    not selected are computed with their t replaced by 1 (the double
    where), so that no lane divides by about 0 and no NaN reaches the
    gradient through a branch that is not taken."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t = torch.stack([1.0 + m00 + m11 + m22,    # 4w^2
                     1.0 + m00 - m11 - m22,    # 4x^2
                     1.0 - m00 + m11 - m22,    # 4y^2
                     1.0 - m00 - m11 + m22],   # 4z^2
                    dim=-1)
    sel = torch.argmax(t, dim=-1)
    one, tiny = t.new_tensor(1.0), t.new_tensor(1e-12)

    def safe(i):
        ti = torch.where(sel == i, t[..., i], one)
        s = torch.sqrt(torch.maximum(ti, tiny))      # = 2 |component i|
        return s, 0.5 / s

    s0, i0 = safe(0)
    cand0 = torch.stack([0.5 * s0, (m21 - m12) * i0,
                         (m02 - m20) * i0, (m10 - m01) * i0], dim=-1)
    s1, i1 = safe(1)
    cand1 = torch.stack([(m21 - m12) * i1, 0.5 * s1,
                         (m01 + m10) * i1, (m02 + m20) * i1], dim=-1)
    s2, i2 = safe(2)
    cand2 = torch.stack([(m02 - m20) * i2, (m01 + m10) * i2,
                         0.5 * s2, (m12 + m21) * i2], dim=-1)
    s3, i3 = safe(3)
    cand3 = torch.stack([(m10 - m01) * i3, (m02 + m20) * i3,
                         (m12 + m21) * i3, 0.5 * s3], dim=-1)
    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)  # (..., 4, 4)
    onehot = F.one_hot(sel, 4).to(m.dtype)[..., None]
    return quat_normalize(torch.sum(cands * onehot, dim=-2))


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation (Zhou et al., CVPR 2019) ->
    rotation matrix: ``x`` (..., 6) holds the first two columns, which
    Gram-Schmidt orthonormalizes; the third is their cross product. Both
    normalizations are soft (_soft_normalize), so the gradient is finite at
    a head output of exactly 0."""
    a1, a2 = x[..., :3], x[..., 3:6]
    b1 = _soft_normalize(a1, 1e-8)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _soft_normalize(a2, 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)     # columns


def matrix_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> its 6D encoding (the first two columns)."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def rot6d_to_quat(x: torch.Tensor) -> torch.Tensor:
    """6D representation -> unit quaternion (w,x,y,z): the head path of
    model.rot_rep="rot6d"."""
    return matrix_to_quat(rot6d_to_matrix(x))


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
