from rgb_proprioceptive_pose_estimator_tpu_torch.models.blocks import (
    BatchNormAct,
    ConvBNReLU,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.cnn_small import CNNSmall
from rgb_proprioceptive_pose_estimator_tpu_torch.models.fusion import (
    PoseEstimator,
    build_model,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.proprio_mlp import (
    ProprioMLP,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
)

__all__ = [
    "ConvBNReLU",
    "BatchNormAct",
    "CNNSmall",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ProprioMLP",
    "PoseEstimator",
    "build_model",
]
