"""Training substrate: AdamW with ZeRO-1 moment specs, the train-step
factory and its state and batch specs, the step over a ``DeviceMesh``
(``train.sharded``), the trainer loop — the port of ``repro.train``."""

from .optimizer import AdamWConfig, adamw_init, adamw_update
from .step import TrainState, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "TrainState", "make_train_step",
    "Trainer", "TrainerConfig",
]
