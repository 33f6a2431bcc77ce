"""Late-fusion pose estimator (counterpart of the JAX package's
``models/fusion.py``), in train and eval mode.

Input batch dict, tensors on the model's device:
    batch["images"][camera] : uint8 (B, H, W, 3) or (B, T, H, W, 3); not
                              read (and may be left out) with
                              model.backbone="none", the proprio-only model
    batch["proprio"]        : float32 (B, D) or (B, T, D)
    batch["camera_mask"]    : float32 (B, n_cameras), optional; 0 = that
                              camera is dead and its features are zeroed
    batch["camera_keep"]    : float32 (B, n_cameras), optional, training
                              with model.camera_dropout only: the keep mask
                              to use instead of drawing one
    batch["camera_forced"]  : float32 (B, n_cameras) one-hot, optional, the
                              same for the camera forced back on (models
                              without proprio)

A camera may be structurally absent from batch["images"]: it contributes
the all-zero feature vector and its encoder does not run.

Output: (pos (B, 3) float32, quat (B, 4) float32 unit-normalized).

T frames either stack along channels before the encoder
(model.temporal_mode="channel") or go through the encoder one by one and
then an LSTM whose last step is the camera's features ("lstm"). The head
emits a quaternion or, with model.rot_rep="rot6d", the continuous 6D form
that ``rot6d_to_quat`` turns into one. In training, model.camera_dropout
zeroes cameras per sample (no rescale), drawn from the ``generator`` the
train step passes; model.proprio_dropout drops proprio features as
flax's ``nn.Dropout`` does (kept ones scaled by 1/(1-p)), from the same
generator. Both are the identity in eval mode. The image encoder is
model.backbone's: CNNSmall, a ResNet or the ViT.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.config import ModelConfig
from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import Dense
from rgb_proprioceptive_pose_estimator_tpu_torch.models.cnn_small import CNNSmall
from rgb_proprioceptive_pose_estimator_tpu_torch.models.lstm import LSTM
from rgb_proprioceptive_pose_estimator_tpu_torch.models.proprio_mlp import ProprioMLP
from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import (
    ResNet18,
    ResNet34,
    ResNet50,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.vit import ViT
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.image_device import (
    normalize_images,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.pose_math import (
    quat_normalize,
    rot6d_to_quat,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """cfg.dtype -> torch dtype (values validated by ModelConfig)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_temporal(img: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C), contiguous."""
    if img.ndim == 4:
        return img
    b, t, h, w, c = img.shape
    return img.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def uses_lstm(cfg: ModelConfig) -> bool:
    """T > 1 frames go through the encoder one by one and then an LSTM."""
    return cfg.temporal_frames > 1 and cfg.temporal_mode == "lstm"


def draw_camera_keep(generator: torch.Generator, p: float, shape,
                     device: torch.device) -> torch.Tensor:
    """Camera dropout's keep mask: f32 of ``shape``, each entry 1 with
    probability 1 - p, drawn from ``generator`` (on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < 1.0 - p).float()


def proprio_dropout(x: torch.Tensor, p: float,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate=p)`` in training: each entry kept with
    probability 1 - p and scaled by 1/(1 - p), else 0. The mask is drawn
    for the global batch from ``generator`` (on x's device) and this
    rank's rows of it are kept."""
    if generator is None:
        raise ValueError(
            "model.proprio_dropout in training draws its mask from a "
            "torch.Generator (forward(batch, generator=...))")
    b = x.shape[0]
    first, rows = dist.rank() * b, dist.world() * b
    u = torch.rand((rows,) + tuple(x.shape[1:]), generator=generator,
                   device=x.device)[first:first + b]
    keep = u < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def draw_forced_camera(generator: torch.Generator, live_in: torch.Tensor,
                       first: int = 0, rows: int = 0) -> torch.Tensor:
    """One-hot (B, n) f32: per row one camera drawn uniformly among those
    with live_in > 0 (any camera in a row without one). The draw is that
    of ``rows`` rows (default B), of which live_in holds rows ``first``
    to ``first + B``: a rank's part of the global batch's."""
    b, n = live_in.shape
    u = torch.rand((rows or b, n), generator=generator,
                   device=live_in.device)[first:first + b]
    score = torch.where(live_in > 0, u, torch.full_like(u, -1.0))
    return F.one_hot(score.argmax(-1), live_in.shape[-1]).float()


_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34,
            "resnet50": ResNet50}


def _encoder(cfg: ModelConfig, dtype: torch.dtype) -> nn.Module:
    """One camera's image encoder for cfg.backbone: it takes one frame in
    the LSTM mode, else the T frames stacked along channels."""
    in_channels = 3 if uses_lstm(cfg) else 3 * cfg.temporal_frames
    if cfg.backbone == "cnn_small":
        return CNNSmall(features=cfg.image_features, in_channels=in_channels,
                        compute_dtype=dtype, bn_stats=cfg.bn_stats)
    if cfg.backbone == "vit":
        return ViT(features=cfg.image_features, image_size=cfg.image_size,
                   in_channels=in_channels, patch=cfg.vit_patch,
                   dim=cfg.vit_dim, depth=cfg.vit_depth, heads=cfg.vit_heads,
                   mlp_ratio=cfg.vit_mlp_ratio, pool=cfg.vit_pool,
                   compute_dtype=dtype, remat=cfg.remat)
    return _RESNETS[cfg.backbone](
        features=cfg.image_features, in_channels=in_channels,
        compute_dtype=dtype, bn_stats=cfg.bn_stats, remat=cfg.remat)


class PoseEstimator(nn.Module):
    """Per-camera image encoders (none with model.backbone="none"), each
    followed by an LSTM in the LSTM mode, + proprio MLP, concatenated into
    the pose head. Submodule names follow the JAX parameter tree
    (``encoder_<camera>``, ``lstm_<camera>``, ``proprio``, ``head<i>``,
    ``pose_out``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.compute_dtype = dtype
        self.cameras = () if cfg.backbone == "none" else tuple(cfg.cameras)
        for cam in self.cameras:
            self.add_module(f"encoder_{cam}", _encoder(cfg, dtype))
            if uses_lstm(cfg):
                self.add_module(f"lstm_{cam}", LSTM(
                    cfg.image_features, cfg.image_features, dtype))
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
        rot_dim = 6 if cfg.rot_rep == "rot6d" else 4
        self.pose_out = Dense(d, 3 + rot_dim, torch.float32)

    def _dropout_mask(self, batch: Dict[str, Any], images: Dict[str, Any],
                      b: int, generator) -> torch.Tensor:
        """Camera dropout's (B, n_cameras) mask, without a 1/(1-p)
        rescale: the keep mask (batch["camera_keep"], else drawn from
        ``generator``) times the cameras live before dropout (present in
        ``images`` and not zeroed by batch["camera_mask"]). Without proprio
        a row whose live cameras all dropped gets one of them back
        (batch["camera_forced"], else drawn); a row with none stays
        dead."""
        cfg = self.cfg
        dev = self.pose_out.weight.device
        n = len(self.cameras)
        # on a rank of a data-parallel group: the global batch's draws,
        # and this rank's rows of them
        first, rows = dist.rank() * b, dist.world() * b

        def need_generator():
            if generator is None:
                raise ValueError(
                    "model.camera_dropout in training draws its masks from "
                    "a torch.Generator (forward(batch, generator=...)) or "
                    "takes batch['camera_keep']")
            return generator

        keep = batch.get("camera_keep")
        if keep is None:
            keep = draw_camera_keep(need_generator(), cfg.camera_dropout,
                                    (rows, n), dev)[first:first + b]
        live_in = torch.tensor([float(c in images) for c in self.cameras],
                               device=dev)
        if batch.get("camera_mask") is not None:
            live_in = live_in * batch["camera_mask"].float()
        live_in = live_in.expand(b, n)
        combined = keep.float() * live_in
        if not cfg.use_proprio:
            forced = batch.get("camera_forced")
            if forced is None:
                forced = draw_forced_camera(need_generator(), live_in,
                                            first, rows)
            dead = torch.logical_and(
                combined.sum(-1, keepdim=True) == 0,
                live_in.sum(-1, keepdim=True) > 0).float()
            combined = combined + dead * forced.float()
        return combined

    def forward(self, batch: Dict[str, Any],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` (on the model's device) draws the camera and
        proprio dropout masks in training, in that order; nothing else
        reads it."""
        cfg = self.cfg
        images = batch["images"] if self.cameras else {}
        present = [c for c in self.cameras if c in images]
        if self.cameras and not present and not cfg.use_proprio:
            raise ValueError(
                f"batch['images'] supplies none of the model's cameras "
                f"{list(cfg.cameras)} and the model has no proprio branch")
        b = (images[present[0]].shape[0] if present
             else batch["proprio"].shape[0])
        cam_mask = batch.get("camera_mask")
        if self.training and cfg.camera_dropout > 0:
            cam_mask = self._dropout_mask(batch, images, b, generator)
        feats = []
        for ci, cam in enumerate(self.cameras):
            img = images.get(cam)
            if img is None:
                # dead sensor: the zeroed features, without the encoder
                feats.append(torch.zeros((b, cfg.image_features),
                                         dtype=self.compute_dtype,
                                         device=self.pose_out.weight.device))
                continue
            encoder = getattr(self, f"encoder_{cam}")
            if uses_lstm(cfg):
                # each frame through the encoder, then the LSTM over the
                # (B, T, features) sequence; its f32 last step goes on
                t = img.shape[1]
                x = normalize_images(img.reshape((b * t,) + img.shape[2:]),
                                     cfg.image_mean, cfg.image_std,
                                     dtype=self.compute_dtype)
                f = getattr(self, f"lstm_{cam}")(encoder(x).reshape(b, t, -1))
            else:
                x = normalize_images(_stack_temporal(img), cfg.image_mean,
                                     cfg.image_std, dtype=self.compute_dtype)
                f = encoder(x)
            if cam_mask is not None:
                f = f * cam_mask[:, ci:ci + 1].to(f.dtype)
            feats.append(f)
        if cfg.use_proprio:
            pf = self.proprio(batch["proprio"])
            if self.training and cfg.proprio_dropout > 0:
                pf = proprio_dropout(pf, cfg.proprio_dropout, generator)
            feats.append(pf)
        if not feats:
            raise ValueError("model has neither image nor proprio inputs")

        # torch.cat promotes as jnp.concatenate does: f32 LSTM features
        # make the concat f32 in bf16 too
        h = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
        for i in range(len(cfg.head_hidden)):
            h = torch.relu(getattr(self, f"head{i}")(h))
        out = self.pose_out(h.float())
        if cfg.rot_rep == "rot6d":
            return out[..., :3], rot6d_to_quat(out[..., 3:])
        return out[..., :3], quat_normalize(out[..., 3:])


def build_model(cfg: ModelConfig) -> PoseEstimator:
    """The model of ``cfg`` (the reference's ``build_model``)."""
    return PoseEstimator(cfg)
