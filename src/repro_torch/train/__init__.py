"""Training substrate of the port (``repro.train``): optimizer, trainer,
checkpointing, fault tolerance."""

from .optim import AdamWConfig, adamw_init, adamw_update
from .trainer import Trainer, TrainState, make_train_step

__all__ = [
    "AdamWConfig",
    "Trainer",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "make_train_step",
]
