"""Training layer: state, optimizers, LR schedules, train/eval steps."""

from .optim import create_optimizer, set_lr
from .schedules import create_schedule
from .state import TrainState, create_train_state, reset_optimizer
from .steps import (
    DropoutNoise,
    add_sums,
    compile_forward,
    cross_entropy_sum,
    eval_forward,
    eval_step,
    make_train_step,
    mark_buffers_static,
    masked_forward,
    train_forward,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "reset_optimizer",
    "create_optimizer",
    "set_lr",
    "create_schedule",
    "make_train_step",
    "DropoutNoise",
    "eval_step",
    "train_forward",
    "eval_forward",
    "compile_forward",
    "mark_buffers_static",
    "masked_forward",
    "cross_entropy_sum",
    "add_sums",
]
