from rgb_proprioceptive_pose_estimator_tpu_torch.losses.pose import (
    pose_loss,
    pose_metrics,
)

__all__ = ["pose_loss", "pose_metrics"]
