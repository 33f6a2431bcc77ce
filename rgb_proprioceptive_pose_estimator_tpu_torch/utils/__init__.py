from rgb_proprioceptive_pose_estimator_tpu_torch.utils import checkpoint
from rgb_proprioceptive_pose_estimator_tpu_torch.utils.metrics import (
    MetricsLogger,
)

# The reference's names whose counterpart has another name here, as a
# path from this package: the orbax manager's save, keep, latest, best
# and restore are the checkpoint module's functions over one file a
# step.
REFERENCE_NAMES = {"CheckpointManager": "checkpoint"}

__all__ = ["MetricsLogger", "checkpoint"]
