from rgb_proprioceptive_pose_estimator_tpu_torch.runtime.native import (
    augment_batch,
    available,
    center_crop_resize_batch,
)

__all__ = ["available", "augment_batch", "center_crop_resize_batch"]
