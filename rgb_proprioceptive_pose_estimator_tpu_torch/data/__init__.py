import os as _os

from rgb_proprioceptive_pose_estimator_tpu_torch.data.hdf5_store import (
    HDF5DemoStore,
    write_demo_fixture,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.data.synthetic import (
    SyntheticProprioDataset,
)

if not _os.environ.get("_RPPE_RENDER_WORKER"):
    # pipeline imports torch; the render child stays torch-free (see the
    # package __init__ note)
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        HostPipeline,
        build_dataset,
    )

__all__ = [
    "SyntheticProprioDataset",
    "HDF5DemoStore",
    "write_demo_fixture",
    "HostPipeline",
    "build_dataset",
]
