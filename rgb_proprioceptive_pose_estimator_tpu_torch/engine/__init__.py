from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
    TrainState,
    create_state,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
    eval_step,
    make_optimizer,
)
from rgb_proprioceptive_pose_estimator_tpu_torch.engine.loop import fit

# The reference's names whose counterpart has another name here, as a
# path from this package. The reference builds jitted step functions;
# the port calls its steps directly. (The function train_step stays in
# its module: exported here, it would hide the module of that name.)
REFERENCE_NAMES = {
    "make_train_step": "train_step.train_step",
    "make_eval_step": "eval_step",
}

__all__ = [
    "TrainState",
    "create_state",
    "eval_step",
    "make_optimizer",
    "fit",
]
