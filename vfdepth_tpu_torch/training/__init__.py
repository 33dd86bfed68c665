from .model import VFDepthModel, loss_config_from
from .step import (create_train_state, eval_step, make_lr_schedule,
                   make_optimizer, train_step)
from .checkpoint import load_checkpoint, save_checkpoint
from .trainer import Trainer

__all__ = ["VFDepthModel", "loss_config_from", "create_train_state",
           "eval_step", "make_lr_schedule", "make_optimizer", "train_step",
           "load_checkpoint", "save_checkpoint", "Trainer"]
