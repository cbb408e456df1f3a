"""Training substrate: AdamW, train-step factory, trainer loop (the port of
``repro.train``; the reference's ZeRO-1 sharding specs wait for ROADMAP
queue 1 item 8.12)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update
from .step import TrainState, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "TrainState", "make_train_step",
    "Trainer", "TrainerConfig",
]
