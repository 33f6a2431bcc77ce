"""PyTorch/CUDA port of the RGB + proprioception pose estimator.

It trains and serves the models of ``rgb_proprioceptive_pose_estimator_tpu``
(the JAX package, which stays the reference) that it covers so far, with
every Pallas kernel replaced by a hand-written CUDA kernel for Hopper
(``csrc/``). The port imports neither JAX nor the JAX package.

    import rgb_proprioceptive_pose_estimator_tpu_torch as rppt

    cfg = rppt.preset("pr3").override(**{"data.path": "lift.hdf5"})
    out = rppt.train(cfg)                               # runs on cuda
    report = rppt.evaluate(cfg, percentiles=True)       # latest checkpoint
    pred = rppt.Predictor(cfg, out["ckpt_dir"])         # latest checkpoint
    pos, quat = pred({"images": {"agentview": img}, "proprio": state})

The CLI: ``python -m rgb_proprioceptive_pose_estimator_tpu_torch.cli``;
grid sweeps: ``run_sweep``; serving artifacts: ``utils/export.py``.
"""

import os as _os

from rgb_proprioceptive_pose_estimator_tpu_torch.config import (
    PRESETS,
    Config,
    DataConfig,
    DistConfig,
    ModelConfig,
    TrainConfig,
    preset,
)

if not _os.environ.get("_RPPE_RENDER_WORKER"):
    # the isolated render child (data/playback._render_in_subprocess)
    # imports no torch: it neither needs it nor may co-host its libraries
    # with software-mesa's; what it runs (playback, hdf5_store, augment)
    # is torch-free
    from rgb_proprioceptive_pose_estimator_tpu_torch.api import (
        Predictor,
        evaluate,
        predict,
        train,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.utils.sweep import (
        run_sweep,
    )

__version__ = "0.1.0"

__all__ = [
    "Config",
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "DistConfig",
    "preset",
    "PRESETS",
    "Predictor",
    "evaluate",
    "predict",
    "train",
    "run_sweep",
    "__version__",
]
