"""Training runtime of the port: optimizers, checkpoints, the trainer."""
from .checkpoint import load_checkpoint, save_checkpoint
from .optim import Optimizer, PlateauScheduler, get_lr, set_lr
from .trainer import Trainer

__all__ = ["Optimizer", "PlateauScheduler", "Trainer", "get_lr", "set_lr",
           "load_checkpoint", "save_checkpoint"]
