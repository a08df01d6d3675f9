"""Train state, the train and eval steps (single-device, and data-parallel
over a mesh), and the training loop."""

from anytime3d_tpu_torch.train.state import TrainState, create_train_state, l2_penalty
from anytime3d_tpu_torch.train.step import LossConfig, make_eval_step, make_train_step, make_train_step_dp

__all__ = [
    "TrainState",
    "create_train_state",
    "l2_penalty",
    "LossConfig",
    "make_train_step",
    "make_train_step_dp",
    "make_eval_step",
]
