"""Proprioceptive state encoder (counterpart of the JAX package's
``models/proprio_mlp.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import Dense


class ProprioMLP(nn.Module):
    """ReLU MLP: state (B, D), or (B, T, D) flattened to (B, T*D), ->
    (B, features).

    With ``normalize`` the state is z-scored per state dim (shared across
    frames) in f32 with the buffers ``proprio_mean``/``proprio_std``,
    before the cast to the compute dtype."""

    def __init__(self, state_dim: int, frames: int = 1,
                 hidden: Sequence[int] = (256, 256), features: int = 128,
                 normalize: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize = normalize
        self.compute_dtype = compute_dtype
        if normalize:
            self.register_buffer("proprio_mean", torch.zeros(state_dim))
            self.register_buffer("proprio_std", torch.ones(state_dim))
        d = state_dim * frames
        self.n_hidden = len(hidden)
        for i, h in enumerate(hidden):
            self.add_module(f"dense{i}", Dense(d, h, compute_dtype))
            d = h
        self.proj = Dense(d, features, compute_dtype)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            s = (s.float() - self.proprio_mean) / self.proprio_std
        if s.ndim > 2:
            s = s.reshape(s.shape[0], -1)
        x = s.to(self.compute_dtype)
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"dense{i}")(x))
        return torch.relu(self.proj(x))
