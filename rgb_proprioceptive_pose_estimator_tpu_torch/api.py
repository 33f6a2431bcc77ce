"""Public serving API of the port: ``Predictor`` and ``predict``
(counterparts of the JAX package's ``api.Predictor``/``api.predict``).

Training and evaluation come in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from rgb_proprioceptive_pose_estimator_tpu_torch.config import Config
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import PoseEstimator
from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device``, or ``cuda`` when None; raises if CUDA is asked for and
    absent (the port never falls back to the CPU by itself)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU")
    return dev


class Predictor:
    """Pose predictor: obs -> (pos, quat).

    Observations may be a single sample (unbatched) or a batch:
        obs["images"][camera]: uint8 (H,W,3) / (T,H,W,3) / (B,[T,]H,W,3)
        obs["proprio"]:        float (D,) / (T,D) / (B,[T,]D)
    Returns float32 numpy (pos, quat) with the batch dim matching the
    input (squeezed for unbatched input). Batches run in chunks of at most
    ``max_batch`` samples.

    Weights come from ``state_dict`` (e.g. ``utils.convert.
    state_dict_from_jax``) or a checkpoint file (``utils.checkpoint``).

    A configured camera may be omitted from obs (sensor died) when the
    model trained with model.camera_dropout > 0 or with
    ``allow_missing_cameras=True``: that camera contributes the zeroed
    feature vector and its encoder does not run. Otherwise a missing
    camera raises KeyError.
    """

    def __init__(self, cfg: Config, ckpt_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 max_batch: int = 8,
                 device: Union[str, torch.device, None] = None,
                 allow_missing_cameras: bool = False):
        if (ckpt_path is None) == (state_dict is None):
            raise ValueError("pass exactly one of ckpt_path and state_dict")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.cfg = cfg
        if state_dict is None:
            _, state_dict = checkpoint.load(ckpt_path)
        model = PoseEstimator(cfg.model)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self.allow_missing_cameras = (allow_missing_cameras
                                      or cfg.model.camera_dropout > 0)

    def _batched(self, obs: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], int, bool]:
        m = self.cfg.model
        present = [c for c in m.cameras if c in obs.get("images", {})]
        missing = [c for c in m.cameras if c not in present]
        if missing and not self.allow_missing_cameras:
            raise KeyError(
                f"obs['images'] is missing cameras {missing} of "
                f"model.cameras={list(m.cameras)}. If the sensor really is "
                "dead, train with model.camera_dropout > 0 (the model then "
                "serves the failure gracefully) or pass "
                "Predictor(..., allow_missing_cameras=True) to accept the "
                "out-of-distribution degradation; if this is a typo'd "
                "camera key, fix the obs dict")
        if not present and not m.use_proprio:
            raise ValueError(
                f"obs supplies none of the model's cameras "
                f"{list(m.cameras)} and the model has no proprio branch")
        # unbatched input is told apart by the proprio or image rank
        if m.use_proprio:
            p = np.asarray(obs["proprio"], dtype=np.float32)
            unbatched = p.ndim == (1 if m.temporal_frames == 1 else 2)
        else:
            img = np.asarray(obs["images"][present[0]])
            unbatched = img.ndim == (3 if m.temporal_frames == 1 else 4)

        def prep(x, dtype):
            x = np.ascontiguousarray(np.asarray(x, dtype=dtype))
            return x[None] if unbatched else x

        batch: Dict[str, Any] = {}
        n = 0
        if m.use_proprio:
            batch["proprio"] = prep(obs["proprio"], np.float32)
            n = batch["proprio"].shape[0]
        batch["images"] = {c: prep(obs["images"][c], np.uint8)
                           for c in present}
        if present:
            n = batch["images"][present[0]].shape[0]
        return batch, n, unbatched

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def warmup(self) -> "Predictor":
        """Run one zeroed max_batch call end to end, so the kernels are
        built and loaded and the first real call pays none of that.
        Returns self for chaining."""
        m = self.cfg.model
        t = (m.temporal_frames,) if m.temporal_frames > 1 else ()
        obs: Dict[str, Any] = {"images": {
            c: np.zeros((self.max_batch, *t, m.image_size, m.image_size, 3),
                        np.uint8) for c in m.cameras}}
        if m.use_proprio:
            obs["proprio"] = np.zeros(
                (self.max_batch, *t, m.proprio_dim), np.float32)
        self(obs)
        return self

    def __call__(self, obs: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        batch, n, unbatched = self._batched(obs)
        pos_parts, quat_parts = [], []
        with torch.inference_mode():
            for lo in range(0, n, self.max_batch):
                hi = lo + self.max_batch
                chunk: Dict[str, Any] = {"images": {
                    c: self._to_device(v[lo:hi])
                    for c, v in batch["images"].items()}}
                if "proprio" in batch:
                    chunk["proprio"] = self._to_device(batch["proprio"][lo:hi])
                p, q = self.model(chunk)
                pos_parts.append(p.float().cpu().numpy())
                quat_parts.append(q.float().cpu().numpy())
        pos = np.concatenate(pos_parts)
        quat = np.concatenate(quat_parts)
        if unbatched:
            pos, quat = pos[0], quat[0]
        return pos, quat


def predict(cfg: Config, obs: Dict[str, Any], ckpt_path: str,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot convenience wrapper; use ``Predictor`` for repeated calls."""
    return Predictor(cfg, ckpt_path=ckpt_path, device=device)(obs)
