"""PyTorch/CUDA port of the RGB + proprioception pose estimator.

It serves the same models as ``rgb_proprioceptive_pose_estimator_tpu`` (the
JAX package, which stays the reference), with the Pallas kernels of the
serving path replaced by hand-written CUDA kernels for Hopper (``csrc/``).
The port imports neither JAX nor the JAX package.

    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt

    cfg = rppt.preset("pr3")
    pred = rppt.Predictor(cfg, ckpt_path="pr3.pt")      # runs on cuda
    pos, quat = pred({"images": {"agentview": img}, "proprio": state})
"""

from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    PRESETS,
    Config,
    DataConfig,
    DistConfig,
    ModelConfig,
    TrainConfig,
    preset,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.api import Predictor, predict

__all__ = [
    "Config",
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "DistConfig",
    "preset",
    "PRESETS",
    "Predictor",
    "predict",
]
