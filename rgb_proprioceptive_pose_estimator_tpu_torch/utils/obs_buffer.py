"""Observation ring buffer for temporal-stacked inference (counterpart of
the JAX package's ``utils/obs_buffer.py``; numpy only).

A robot control loop produces one observation per tick; a temporal model
(`temporal_frames=T`) wants the T most recent frames. This buffer does the
windowing with clamp-at-start padding, matching the training-side windowing
of `data/hdf5_store.py` exactly, so `Predictor` sees the same input
distribution online as the model saw in training.

    buf = ObsBuffer(cfg.model)
    pred = Predictor(cfg)
    for obs in control_loop:        # obs: single-step images/proprio
        pos, quat = pred(buf.push(obs))

Dead-sensor frames (composing the two pr5 serving features): a pushed
frame MAY omit a camera (the sensor died mid-episode). The stacked window
then omits that camera entirely — whole-window structural absence — for as
long as any frame in the window lacks it. That is the camera-dropout-
consistent choice, not an approximation: training-time `camera_dropout`
zeroes a camera's features per SAMPLE (one (B, n_cameras) mask applied to
the final per-camera feature vector, models/fusion.py), never per frame,
so "camera dead for part of the window" is a distribution the model never
saw. Collapsing it to whole-window-dead serves exactly the representation
training sampled, and reuses Predictor's structural dead-camera signature
(the encoder never runs). When the sensor returns, the camera revives
automatically once it has been present for T consecutive frames.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List

import numpy as np

from rgb_proprioceptive_pose_estimator_tpu_torch.config import ModelConfig


class ObsBuffer:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._frames: deque = deque(maxlen=max(cfg.temporal_frames, 1))

    def reset(self) -> None:
        """Call at episode boundaries."""
        self._frames.clear()

    def __len__(self) -> int:
        """Number of REAL frames in the current window (<= temporal_frames);
        the serving layer reports it as window_fill so a client can detect
        a clamp-padded (fresh or evicted-and-recreated) window."""
        return len(self._frames)

    def dead_cameras(self) -> List[str]:
        """Configured cameras the CURRENT window would omit (absent from at
        least one buffered frame). Empty for non-image models."""
        if self.cfg.backbone == "none" or not self._frames:
            return []
        return [cam for cam in self.cfg.cameras
                if any(cam not in f.get("images", {}) for f in self._frames)]

    def push(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        """Add a single-step observation; return the model-ready
        (unbatched) temporally-stacked observation. A camera missing from
        any frame of the window is omitted from the result (structural
        dead camera -- see the module docstring)."""
        self._frames.append(obs)
        t = self.cfg.temporal_frames
        if t == 1:
            return obs
        # clamp-at-start: repeat the oldest frame, same as training windows
        frames = list(self._frames)
        frames = [frames[0]] * (t - len(frames)) + frames

        out: Dict[str, Any] = {}
        if self.cfg.backbone != "none":
            dead = set(self.dead_cameras())
            out["images"] = {
                cam: np.stack([np.asarray(f["images"][cam]) for f in frames])
                for cam in self.cfg.cameras if cam not in dead
            }
        if self.cfg.use_proprio:
            out["proprio"] = np.stack(
                [np.asarray(f["proprio"], dtype=np.float32) for f in frames])
        return out
