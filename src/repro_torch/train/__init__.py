"""Training (port of ``repro.train``): AdamW, the train step and the
trainer; see train/train_step.py."""

from repro_torch.train.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.train.train_step import TrainConfig, init_train_state, make_loss_fn, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "OptimizerConfig",
    "apply_updates",
    "init_opt_state",
    "TrainConfig",
    "init_train_state",
    "make_loss_fn",
    "make_train_step",
    "Trainer",
    "TrainerConfig",
]
