"""Checkpointing: atomic, manifest-driven, restore onto the like's devices
(the port of ``repro.ckpt``)."""

from .checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
