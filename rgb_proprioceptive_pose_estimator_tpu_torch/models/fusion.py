"""Late-fusion pose estimator (counterpart of the JAX package's
``models/fusion.py``), in train and eval mode.

Input batch dict, tensors on the model's device:
    batch["images"][camera] : uint8 (B, H, W, 3) or (B, T, H, W, 3); not
                              read (and may be left out) with
                              model.backbone="none", the proprio-only model
    batch["proprio"]        : float32 (B, D) or (B, T, D)
    batch["camera_mask"]    : float32 (B, n_cameras), optional; 0 = that
                              camera is dead and its features are zeroed

A camera may be structurally absent from batch["images"]: it contributes
the all-zero feature vector and its encoder does not run.

Output: (pos (B, 3) float32, quat (B, 4) float32 unit-normalized).

The port covers the backbones none, cnn_small, resnet18, resnet34 and
resnet50 (with model.remat), T frames stacked along channels, and the
quaternion head; the ViT backbone, the LSTM temporal mode, the rot6d head
and training with camera or proprio dropout come in later slices
(ROADMAP.md queue A) and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.config import ModelConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import Dense
from rgb_proprioceptive_pose_estimator_tpu_torch.models.cnn_small import CNNSmall
from rgb_proprioceptive_pose_estimator_tpu_torch.models.proprio_mlp import ProprioMLP
from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    ResNet50,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.image_device import (
    normalize_images,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.pose_math import quat_normalize


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """cfg.dtype -> torch dtype (values validated by ModelConfig)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_temporal(img: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C), contiguous."""
    if img.ndim == 4:
        return img
    b, t, h, w, c = img.shape
    return img.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model options this slice lacks."""
    if cfg.backbone == "vit":
        raise NotImplementedError(
            "model.backbone='vit': the ViT backbone comes in a later slice "
            "(ROADMAP.md queue A, item 10)")
    if cfg.rot_rep != "quat":
        raise NotImplementedError(
            f"model.rot_rep={cfg.rot_rep!r}: the port has the quat head so "
            "far; rot6d comes in a later slice (ROADMAP.md queue A, item 8)")
    if cfg.temporal_frames > 1 and cfg.temporal_mode == "lstm":
        raise NotImplementedError(
            "model.temporal_mode='lstm': the port stacks frames along "
            "channels so far; the LSTM mode comes in a later slice "
            "(ROADMAP.md queue A, item 8)")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for training options the port lacks (each
    is the identity in eval mode)."""
    if cfg.camera_dropout > 0:
        raise NotImplementedError(
            "model.camera_dropout > 0 in training: camera dropout comes in a "
            "later slice (ROADMAP.md queue A, item 8)")
    if cfg.proprio_dropout > 0:
        raise NotImplementedError(
            "model.proprio_dropout > 0 in training: proprio dropout comes in "
            "a later slice (ROADMAP.md queue A, item 9)")


_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34,
            "resnet50": ResNet50}


def _encoder(cfg: ModelConfig, dtype: torch.dtype) -> nn.Module:
    """One camera's image encoder for cfg.backbone."""
    in_channels = 3 * cfg.temporal_frames
    if cfg.backbone == "cnn_small":
        return CNNSmall(features=cfg.image_features, in_channels=in_channels,
                        compute_dtype=dtype, bn_stats=cfg.bn_stats)
    return _RESNETS[cfg.backbone](
        features=cfg.image_features, in_channels=in_channels,
        compute_dtype=dtype, bn_stats=cfg.bn_stats, remat=cfg.remat)


class PoseEstimator(nn.Module):
    """Per-camera image encoders (none with model.backbone="none") +
    proprio MLP, concatenated into the pose head. Submodule names follow
    the JAX parameter tree (``encoder_<camera>``, ``proprio``, ``head<i>``,
    ``pose_out``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.compute_dtype = dtype
        self.cameras = () if cfg.backbone == "none" else tuple(cfg.cameras)
        for cam in self.cameras:
            self.add_module(f"encoder_{cam}", _encoder(cfg, dtype))
        d = cfg.image_features * len(self.cameras)
        if cfg.use_proprio:
            self.proprio = ProprioMLP(
                cfg.proprio_dim, frames=cfg.temporal_frames,
                hidden=cfg.proprio_hidden, features=cfg.proprio_features,
                normalize=cfg.proprio_normalize, compute_dtype=dtype)
            d += cfg.proprio_features
        for i, hd in enumerate(cfg.head_hidden):
            self.add_module(f"head{i}", Dense(d, hd, dtype))
            d = hd
        self.pose_out = Dense(d, 7, torch.float32)

    def forward(self, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if self.training:
            check_trainable(cfg)
        images = batch["images"] if self.cameras else {}
        present = [c for c in self.cameras if c in images]
        if self.cameras and not present and not cfg.use_proprio:
            raise ValueError(
                f"batch['images'] supplies none of the model's cameras "
                f"{list(cfg.cameras)} and the model has no proprio branch")
        b = (images[present[0]].shape[0] if present
             else batch["proprio"].shape[0])
        cam_mask = batch.get("camera_mask")
        feats = []
        for ci, cam in enumerate(self.cameras):
            img = images.get(cam)
            if img is None:
                # dead sensor: the zeroed features, without the encoder
                feats.append(torch.zeros((b, cfg.image_features),
                                         dtype=self.compute_dtype,
                                         device=self.pose_out.weight.device))
                continue
            x = normalize_images(_stack_temporal(img), cfg.image_mean,
                                 cfg.image_std, dtype=self.compute_dtype)
            f = getattr(self, f"encoder_{cam}")(x)
            if cam_mask is not None:
                f = f * cam_mask[:, ci:ci + 1].to(f.dtype)
            feats.append(f)
        if cfg.use_proprio:
            feats.append(self.proprio(batch["proprio"]))
        if not feats:
            raise ValueError("model has neither image nor proprio inputs")

        h = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        for i in range(len(cfg.head_hidden)):
            h = torch.relu(getattr(self, f"head{i}")(h))
        out = self.pose_out(h.float())
        return out[..., :3], quat_normalize(out[..., 3:])
