from .model import VFDepthModel, loss_config_from
from .step import (create_train_state, make_lr_schedule, make_optimizer,
                   train_step)

__all__ = ["VFDepthModel", "loss_config_from", "create_train_state",
           "make_lr_schedule", "make_optimizer", "train_step"]
