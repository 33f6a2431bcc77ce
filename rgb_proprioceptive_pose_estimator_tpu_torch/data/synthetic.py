"""Synthetic proprio-only dataset (C15, BASELINE.json:7).

Pose is a fixed random smooth function of the state vector plus noise, so a
proprio MLP can drive the loss toward the noise floor -- the CPU-runnable
end-to-end learning smoke test (SURVEY.md section 5.2 integration)."""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticProprioDataset:
    def __init__(self, size: int = 4096, proprio_dim: int = 32,
                 noise: float = 0.01, seed: int = 0,
                 temporal_frames: int = 1, split: str = "all",
                 val_fraction: float = 0.0):
        rs = np.random.RandomState(seed ^ 0x5EED)
        self.size = size
        self.proprio_dim = proprio_dim
        self.temporal_frames = temporal_frames
        d = proprio_dim * temporal_frames

        # ground-truth map: pos = tanh(S) @ Wp, quat = normalize(tanh(S) @ Wq + b)
        self._wp = (rs.randn(d, 3) / np.sqrt(d)).astype(np.float32)
        self._wq = (rs.randn(d, 4) / np.sqrt(d)).astype(np.float32)
        self._bq = rs.randn(4).astype(np.float32) * 0.5

        states = rs.randn(size, temporal_frames, proprio_dim).astype(np.float32)
        feats = np.tanh(states.reshape(size, d))
        pos = feats @ self._wp + noise * rs.randn(size, 3).astype(np.float32)
        quat = feats @ self._wq + self._bq
        quat += noise * rs.randn(size, 4).astype(np.float32)
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

        if temporal_frames == 1:
            states = states[:, 0]

        # train/val split by index (same generated universe either way)
        if val_fraction > 0 and split != "all":
            n_val = max(1, int(round(size * val_fraction)))
            sl = slice(size - n_val, None) if split == "val" else (
                slice(0, size - n_val))
            states, pos, quat = states[sl], pos[sl], quat[sl]
            self.size = states.shape[0]

        self._states = states
        self._pos = pos.astype(np.float32)
        self._quat = quat.astype(np.float32)

    def __len__(self) -> int:
        return self.size

    def proprio_stats(self):
        """Per-dim (mean, std) of this split's state vectors (floor 1e-6),
        same contract as HDF5DemoStore.proprio_stats."""
        s = self._states.reshape(-1, self._states.shape[-1])
        return (s.mean(0, dtype=np.float64).astype(np.float32),
                np.maximum(s.std(0, dtype=np.float64), 1e-6)
                .astype(np.float32))

    def get_batch(self, indices: np.ndarray, augment: bool = False,
                  seed: int = 0) -> Dict[str, np.ndarray]:
        return {
            "proprio": self._states[indices],
            "target_pos": self._pos[indices],
            "target_quat": self._quat[indices],
        }
