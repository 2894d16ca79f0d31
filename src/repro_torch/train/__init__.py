"""Training substrate of the port (port of ``repro.train``): atomic
checkpoints and the fault-tolerant training loop."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .trainer import TrainConfig, Trainer, make_train_step

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "TrainConfig",
    "Trainer",
    "make_train_step",
]
