from rgb_proprioceptive_pose_estimator_tpu_torch.ops import pose_math
from rgb_proprioceptive_pose_estimator_tpu_torch.ops.image_device import (
    normalize_images,
)

__all__ = ["pose_math", "normalize_images"]
