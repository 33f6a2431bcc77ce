"""Pose regression loss and evaluation metrics (counterpart of the JAX
package's ``losses/pose.py``).

loss = pos_weight * (MSE or Huber of the position) + rot_weight * (the
chordal 1 - <q,q'>^2 or the clipped geodesic angle), in f32 whatever the
compute dtype; metrics are the position error in cm and the geodesic
rotation error in degrees.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.ops import pose_math


def _check_shapes(pred_pos: torch.Tensor, pred_quat: torch.Tensor,
                  target_pos: torch.Tensor, target_quat: torch.Tensor) -> None:
    if pred_pos.shape != target_pos.shape or pred_pos.shape[-1:] != (3,):
        raise ValueError(f"positions must both be (..., 3), got "
                         f"{tuple(pred_pos.shape)} and "
                         f"{tuple(target_pos.shape)}")
    if pred_quat.shape != target_quat.shape or pred_quat.shape[-1:] != (4,):
        raise ValueError(f"quaternions must both be (..., 4), got "
                         f"{tuple(pred_quat.shape)} and "
                         f"{tuple(target_quat.shape)}")


def _f32(pred_pos, pred_quat, target_pos, target_quat):
    return (pred_pos.float(), pose_math.quat_normalize(pred_quat.float()),
            target_pos.float(), pose_math.quat_normalize(target_quat.float()))


def pose_loss(
    pred_pos: torch.Tensor,
    pred_quat: torch.Tensor,
    target_pos: torch.Tensor,
    target_quat: torch.Tensor,
    pos_weight: float = 1.0,
    rot_weight: float = 1.0,
    rot_loss: str = "chordal",
    pos_loss: str = "mse",
    huber_delta: float = 0.05,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar loss, {"loss", "pos_loss", "rot_loss"}) for (..., 3) and
    (..., 4) inputs. Both quaternions are normalized here."""
    _check_shapes(pred_pos, pred_quat, target_pos, target_quat)
    pred_pos, pred_quat, target_pos, target_quat = _f32(
        pred_pos, pred_quat, target_pos, target_quat)

    # mean over coordinates too (torch nn.MSELoss)
    err = pred_pos - target_pos
    if pos_loss == "mse":
        pos_l = torch.mean(torch.square(err))
    elif pos_loss == "huber":
        # torch nn.HuberLoss(reduction="mean", delta)
        a = torch.abs(err)
        per = torch.where(a <= huber_delta, 0.5 * torch.square(err),
                          huber_delta * (a - 0.5 * huber_delta))
        pos_l = torch.mean(per)
    else:
        raise ValueError(f"unknown pos_loss {pos_loss!r}")
    if rot_loss == "chordal":
        rot_l = torch.mean(pose_math.quat_chordal_distance(pred_quat,
                                                           target_quat))
    elif rot_loss == "geodesic":
        rot_l = torch.mean(pose_math.quat_geodesic_angle(pred_quat,
                                                         target_quat))
    else:
        raise ValueError(f"unknown rot_loss {rot_loss!r}")

    loss = pos_weight * pos_l + rot_weight * rot_l
    return loss, {"loss": loss, "pos_loss": pos_l, "rot_loss": rot_l}


def pose_errors(
    pred_pos: torch.Tensor,
    pred_quat: torch.Tensor,
    target_pos: torch.Tensor,
    target_quat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (position error in cm, geodesic rotation error in
    degrees), each shaped like the batch."""
    pred_pos, pred_quat, target_pos, target_quat = _f32(
        pred_pos, pred_quat, target_pos, target_quat)
    pos_err_m = torch.linalg.vector_norm(pred_pos - target_pos, dim=-1)
    # no gradient here: report true zeros (the grad_safe clip would floor
    # the metric at 0.16 deg)
    ang_rad = pose_math.quat_geodesic_angle(pred_quat, target_quat,
                                            grad_safe=False)
    return pos_err_m * 100.0, ang_rad * (180.0 / math.pi)


def pose_metrics(
    pred_pos: torch.Tensor,
    pred_quat: torch.Tensor,
    target_pos: torch.Tensor,
    target_quat: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """{"pos_mae_cm", "rot_mae_deg"}: the batch means of pose_errors (of
    the normalized quaternions, normalized once more there, as in the JAX
    package)."""
    pos_err_cm, rot_err_deg = pose_errors(*_f32(pred_pos, pred_quat,
                                                target_pos, target_quat))
    return {"pos_mae_cm": torch.mean(pos_err_cm),
            "rot_mae_deg": torch.mean(rot_err_deg)}
